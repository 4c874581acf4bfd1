"""The window lattice sharded over a (data, key) mesh (the port of
hstream_tpu/parallel/lattice.py:85-327, ShardedLattice, and of the
snapshot's _merge_partials, engine/snapshot.py:258), and the key-sharded
session arena and interval-join stores (:617-784 ShardedSessionLattice,
:340-615 ShardedJoinLattice; their own sections below).

Every shard (d, k) holds a partial lattice of the Kl = K / n_key keys
that key shard k owns, [Kl, W, ...] a plane, on its mesh device; the
state is a ShardedState, state[d][k] a plane dict with engine/lattice.py's
names and layouts. A packed batch's records split into n_data contiguous
blocks of cap / n_data (the reference's P(None, data)); each key shard
folds its data block with its keys shifted by -k * Kl, so a record of
another key shard leaves its planes alone but still advances its slot
starts (the reference's slot_valid). There is no merge in the step. The
drain points merge the D partials of every cell by each plane's monoid
(lattice.plane_merge_kinds) inside the kernels that read them:

  unpack_block     <- step_local's unpack and key shift (:173-190)
                      (engine/kernels/csrc/unpack.cu, with a row pitch)
  close_merged     <- extract_reset_slots / extract_slots / reset_slots
                      (:235-293)               (csrc/close.cu, merged)
  close_slot_merged <- extract_slot / reset_slot (:192-233)
                      (csrc/close.cu, hs_close_slot_merged)
  touched_merged   <- extract_touched (:297-326) (csrc/touched.cu, merged)
  merge_partials   <- engine/snapshot.py:258 _merge_partials
                      (csrc/shard_merge.cu)

and the scatter, expression and rebase kernels of engine/lattice.py run
per shard as they are. Each wrapper launches its kernel when the planes
lie on the card and counts the launch, and runs the plain PyTorch version
beside it only when they lie on the CPU. One launch of a merged kernel
covers every key shard whose data-0 partial is on one card, whatever the
number of partials: the kernels read the partials' plane pointers from a
table on the card (part_table), uploaded again only when a pointer
changed. Where a key shard's partials lie on other cards, they are
copied to its data-0 card first (a copy on a side stream, behind an
event) and the reset copies copied back. Every launch for a card runs
with that card current (the CUDA runtime launches a kernel only on a
stream of the current device).
"""

from __future__ import annotations

import contextlib
import ctypes
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

from hstream_tpu_torch.engine import join_lattice as jl
from hstream_tpu_torch.engine import lattice
from hstream_tpu_torch.engine import session_lattice as sl
from hstream_tpu_torch.engine.expr import eval_programs, ftz
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.kernels.binding import (
    CLOSE_EXTRACT,
    CLOSE_EXTRACT_RESET,
    CLOSE_RESET,
)
from hstream_tpu_torch.engine.lattice import LatticeSpec, plane_merge_kinds
from hstream_tpu_torch.engine.plan import AggKind


class ShardedState(list):
    """The partial lattices of a mesh: state[d][k] is shard (d, k)'s plane
    dict, [Kl, W, ...] a keyed plane and its own slot_start [W]."""

    @property
    def n_data(self) -> int:
        return len(self)

    @property
    def n_key(self) -> int:
        return len(self[0])

    def key_shard(self, k: int) -> list[dict[str, torch.Tensor]]:
        """The D partials of key shard k, data shard 0 first."""
        return [row[k] for row in self]


def _device(part: Mapping[str, torch.Tensor]) -> torch.device:
    return part["count"].device


def on(dev: torch.device):
    """`dev` made the current CUDA device for the launches of a shard on
    it (a kernel launched on another device's stream fails); nothing on
    the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


# ---- the monoid merges (plain) ----------------------------------------------


def merge_planes(kind: str, xs: list[torch.Tensor]) -> torch.Tensor:
    """The merge of the same plane of several partials, in their order:
    int32 sums wrap, float32 sums add one partial at a time and flush as
    the kernels do, min / max elementwise, a bool max is the any."""
    acc = xs[0].clone()
    for x in xs[1:]:
        if kind == "sum":
            acc = ftz(acc + x) if acc.dtype == torch.float32 else acc + x
        elif kind == "min":
            acc = torch.minimum(acc, x)
        elif kind == "max":
            acc = acc | x if acc.dtype == torch.bool else torch.maximum(acc, x)
        else:
            raise ValueError(f"no elementwise merge for kind {kind!r}")
    return acc


def _merged(spec: LatticeSpec, parts: list[dict], pick=lambda v: v
            ) -> dict[str, torch.Tensor]:
    """Every plane of a key shard merged over its D partials, each taken
    through `pick` first (a slot column, or the whole plane)."""
    kinds = plane_merge_kinds(spec)
    return {name: merge_planes(kinds[name], [pick(p[name]) for p in parts])
            for name in parts[0]}


def _refuse_topk(spec: LatticeSpec) -> None:
    bad = sorted(k for k, v in plane_merge_kinds(spec).items()
                 if v not in ("sum", "min", "max"))
    if bad:
        raise ValueError(
            f"plane(s) {bad} have no elementwise merge (TOPK): "
            "sharded execution is not supported for this query")


# ---- the sharded step: one data block, shifted keys -------------------------


def unpack_block_ref(packed: torch.Tensor, lo: int, count: int, layout,
                     null_keys, key_subs):
    """Plain unpack of records [lo, lo + count) of a packed batch: (keys
    [len(key_subs), count], one column a key shard with key - key_subs[j],
    ts, valid, cols) as engine/lattice.unpack_batch gives them."""
    block = packed[:, lo:lo + count]
    _k, ts, valid, cols = lattice.unpack_batch(block, layout, null_keys)
    keys = torch.stack([block[0] - int(s) for s in key_subs])
    return keys, ts, valid, cols


def _unpack_block_cuda(packed: torch.Tensor, lo: int, count: int, layout,
                       null_keys, key_subs):
    dev = packed.device
    args = kb.UnpackArgs()
    args.packed = packed.data_ptr() + 4 * lo
    args.cap, args.pitch = count, packed.shape[1]

    def byte_col() -> torch.Tensor:
        return torch.empty(count, dtype=torch.bool, device=dev)

    valid = byte_col()
    args.valid = valid.data_ptr()
    cols: dict[str, torch.Tensor] = {}
    n_bool = 0
    for i, (name, tag) in enumerate(layout):
        row = packed[3 + i, lo:lo + count]
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
    masks = [nk for nk in null_keys if nk is not None]
    if len(masks) > kb.MAX_AGGS:
        raise ValueError(f"more than {kb.MAX_AGGS} NULL masks")
    for j, nk in enumerate(masks):
        cols[nk] = byte_col()
        args.null_out[j] = cols[nk].data_ptr()
    args.n_bool, args.n_null = n_bool, len(masks)
    keys = torch.empty((len(key_subs), count), dtype=torch.int32, device=dev)
    args.n_key_out, args.key_out = len(key_subs), keys.data_ptr()
    for j, s in enumerate(key_subs):
        args.key_sub[j] = int(s)
    kb.check(kb.lib().hs_unpack(ctypes.byref(args), kb.stream_of(packed)),
             "unpack_block")
    return keys, packed[1, lo:lo + count], valid, cols


def unpack_block(packed: torch.Tensor, lo: int, count: int, layout,
                 null_keys, key_subs):
    """A data shard's block of a packed batch, in place of the reference's
    shard_map split: (keys [n, count], ts, valid, cols), key column j
    shifted by -key_subs[j] for the key shards on the packed buffer's
    device. ts, f32 and i32 columns are views of the buffer; valid, bool
    columns, NULL masks and the key columns are written by the unpack
    kernel (a row pitch, no copy of the block) on the card, by
    unpack_block_ref on the CPU."""
    if (packed.dtype != torch.int32 or packed.dim() != 2
            or packed.shape[0] != 3 + len(layout)
            or not packed.is_contiguous()):
        raise ValueError("unpack_block: packed must be a contiguous int32 "
                         "[3 + n_cols, B] buffer")
    if not (0 <= lo and 0 < count and lo + count <= packed.shape[1]):
        raise ValueError("unpack_block: block out of range")
    if not key_subs:
        raise ValueError("unpack_block: no key shard")
    if packed.device.type == "cpu":
        return unpack_block_ref(packed, lo, count, layout, null_keys,
                                key_subs)
    if len(key_subs) > kb.UNPACK_KEYS:
        raise ValueError(f"unpack_block: at most {kb.UNPACK_KEYS} key "
                         "columns a launch")
    out = _unpack_block_cuda(packed, lo, count, layout, null_keys, key_subs)
    unpack_block.launches += 1
    return out


unpack_block.launches = 0  # wrapper calls that launched the kernel


# ---- the partial table of the merged kernels --------------------------------

# the merged kernels' launches by wrapper, one a card a call (the
# wrappers' .launches count calls)
CARD_LAUNCHES = {"close_merged": 0, "close_slot_merged": 0,
                 "touched_merged": 0, "merge_partials": 0}



def _plane_slots(spec: LatticeSpec) -> list[tuple[int, str]]:
    """(table index, plane name) of every plane a partial has."""
    out = [(kb.PART_COUNT, "count"), (kb.PART_SLOT_START, "slot_start"),
           (kb.PART_TOUCHED, "touched")]
    for g, agg in enumerate(spec.aggs):
        if agg.kind == AggKind.COUNT_ALL:
            continue
        name = lattice._plane_name(g, agg)
        out.append((3 + 2 * g, name))
        if agg.kind == AggKind.AVG:
            out.append((4 + 2 * g, name + "_n"))
    return out


def part_planes(spec: LatticeSpec) -> int:
    """A partial's entries in the partial table: count, slot_start,
    touched, then two an aggregate (its plane, AVG's count)."""
    return 3 + 2 * len(spec.aggs)


def _addr(t: torch.Tensor) -> int:
    if not t.is_contiguous():
        raise ValueError("a partial's planes must be contiguous")
    return t.data_ptr()


def part_table_key(spec: LatticeSpec, by_key: list[list[dict]]
                   ) -> tuple[int, ...]:
    """The partial table of one launch (csrc/hs_kernels.h HsParts), as
    the planes' addresses: key shard s's data shard d's plane i at entry
    (s * D + d) * part_planes(spec) + i, 0 where the query has no such
    plane (COUNT(*)'s, a non-AVG's count)."""
    D, n_planes = len(by_key[0]), part_planes(spec)
    slots = _plane_slots(spec)
    out = [0] * (len(by_key) * D * n_planes)
    for s, partials in enumerate(by_key):
        for d, part in enumerate(partials):
            base = (s * D + d) * n_planes
            for i, name in slots:
                out[base + i] = _addr(part[name])
    return tuple(out)


_TABLES_KEPT = 32      # uploads kept a card, the least recently used go
_part_tables: dict = {}


def _upload(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host buffer on `dev`: a blocking copy (PyTorch synchronizes a
    pageable upload), so any stream may read it at once."""
    return host if dev.type == "cpu" else host.to(dev)


def _cached(tables: dict, dev: torch.device, key, build):
    """tables[dev][key], made by build() where it is missing; a card
    keeps the _TABLES_KEPT most recently used."""
    mine = tables.setdefault(dev, OrderedDict())
    got = mine.get(key)
    if got is None:
        got = mine[key] = build()
        if len(mine) > _TABLES_KEPT:
            mine.popitem(last=False)
    else:
        mine.move_to_end(key)
    return got


def part_table(spec: LatticeSpec, by_key: list[list[dict]],
               dev: torch.device, key: tuple[int, ...] | None = None
               ) -> torch.Tensor:
    """The partial table of one launch on `dev` (int64 addresses,
    part_table_key's), uploaded only where it is not cached on that card
    already: the cache is keyed by the addresses, which steps, closes and
    extracts keep (they update the planes in place), and a restore, a key
    growth or a copy from another card changes. A table holds addresses
    only, so one whose key matches is right. part_table.uploads counts
    the uploads."""
    if key is None:
        key = part_table_key(spec, by_key)

    def build():
        part_table.uploads += 1
        words = [w - (1 << 64) if w >= 1 << 63 else w for w in key]
        return _upload(torch.tensor(words, dtype=torch.int64), dev)

    return _cached(_part_tables, dev, key, build)


part_table.uploads = 0


def _parts_args(spec: LatticeSpec, by_key: list[list[dict]],
                dev: torch.device, key: tuple[int, ...] | None = None
                ) -> tuple[kb.Parts, torch.Tensor]:
    """The partial table's argument block of one launch on `dev` and the
    table (held by the caller until the launch is queued)."""
    tab = part_table(spec, by_key, dev, key)
    if tab.is_cuda:  # a table made on another stream stays until this
        tab.record_stream(torch.cuda.current_stream(dev))  # one's done
    parts = kb.Parts()
    parts.n_data, parts.n_key = len(by_key[0]), len(by_key)
    parts.local_keys, parts.n_planes = spec.n_keys, part_planes(spec)
    parts.tab = tab.data_ptr()
    return parts, tab


_side_streams: dict = {}


def _gather(partials: list[dict], dev: torch.device):
    """Key shard's partials on `dev`: those elsewhere are copied on a side
    stream of `dev`, behind the partial's own stream, and the current
    stream of `dev` waits on an event of the copy; the copies are marked
    as used by that stream, so the allocator does not hand their memory
    to the side stream again before the kernels and the copy back are
    done. Returns (partials on dev, [(original, copy)] to copy back after
    a reset)."""
    out, back = [], []
    for part in partials:
        src = _device(part)
        if src == dev:
            out.append(part)
            continue
        side = _side_streams.get(dev)
        if side is None:
            side = _side_streams[dev] = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(src))
        with torch.cuda.stream(side):
            cp = {k: v.to(dev, non_blocking=True) for k, v in part.items()}
        done = torch.cuda.Event()
        done.record(side)
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(done)
        for v in cp.values():
            v.record_stream(cur)
        out.append(cp)
        back.append((part, cp))
    return out, back


def _put_back(back) -> None:
    for orig, cp in back:
        for k, v in orig.items():
            v.copy_(cp[k], non_blocking=True)


def _by_card(devices: list, per: int | None = None
             ) -> list[tuple[torch.device, list[int]]]:
    """(card, shards) for the shards on each card (devices[s] is shard
    s's), in shard order, cut into launches of at most `per` shards
    (None: one launch a card)."""
    by_card: dict = {}
    for s, d in enumerate(devices):
        by_card.setdefault(d, []).append(s)
    return [(d, ks[i:i + (per or len(ks))]) for d, ks in by_card.items()
            for i in range(0, len(ks), per or len(ks))]


def merged_groups(state: ShardedState
                  ) -> list[tuple[torch.device, list[int]]]:
    """The launches of a merged close or changelog extract: (card, key
    shards) for the key shards whose data-0 partial lies on each card, in
    key order, one launch a card whatever the number of partials (the
    kernels read them through the partial table on the card)."""
    return _by_card([_device(state[0][k]) for k in range(state.n_key)])


def _key_cols(ks: list[int], Kl: int) -> list[tuple]:
    """(global key range, launch key range) of each key shard of a
    launch over the key shards ks."""
    return [(slice(k * Kl, (k + 1) * Kl), slice(j * Kl, (j + 1) * Kl))
            for j, k in enumerate(ks)]


# ---- the merged close --------------------------------------------------------


def close_merged_ref(spec: LatticeSpec, state: ShardedState,
                     slots: np.ndarray, mode: int) -> torch.Tensor | None:
    """Plain merged close over the padded slot vector (< 0 = padding):
    each key shard's slot columns merged over its D partials, finalized
    and packed [P, 2+rows, Kl] as lattice.extract_slots_ref packs them,
    concatenated over the key shards -> [P, 2+rows, K]; then (modes 0
    and 2) the slots reset in every partial."""
    slots_t = torch.from_numpy(np.asarray(slots, np.int32)).to(
        _device(state[0][0]))
    out = None
    if mode != CLOSE_RESET:
        valid = slots_t >= 0
        safe = torch.where(valid, slots_t, 0).long()
        bufs = []
        for k in range(state.n_key):
            parts = state.key_shard(k)
            col = _merged(spec, [{n: v for n, v in p.items()
                                  if n not in ("slot_start", "touched")}
                                 for p in parts], lambda v: v[:, safe])
            ws = merge_planes("max", [p["slot_start"][safe] for p in parts])
            outs = lattice.finalize_column(spec, col)
            packed = lattice.pack_extract_rows(spec, col["count"],
                                               ws[None, :], outs)
            packed = packed.permute(2, 0, 1)
            bufs.append(torch.where(valid[:, None, None], packed,
                                    torch.zeros_like(packed)))
        out = torch.cat(bufs, dim=2).contiguous()
    if mode != CLOSE_EXTRACT:
        for row in state:
            for part in row:
                lattice.reset_slots_ref(spec, part, slots_t)
    return out


def _merged_close_args(spec: LatticeSpec, by_key: list[list[dict]],
                       mode: int, dev: torch.device
                       ) -> tuple[kb.MergedCloseArgs, torch.Tensor]:
    """The merged close's argument block and the partial table it
    points at."""
    m = kb.MergedCloseArgs()
    # the single-card argument block of data shard 0's first partial:
    # its sizes, modes and finalize table (its pointers are unused)
    m.c = lattice._close_args(spec, by_key[0][0], mode)
    m.c.n_keys = spec.n_keys * len(by_key)
    m.parts, tab = _parts_args(spec, by_key, dev)
    return m, tab


def _close_merged_cuda(spec: LatticeSpec, state: ShardedState,
                       slots: np.ndarray, mode: int) -> torch.Tensor | None:
    P, Kl = len(slots), spec.n_keys
    groups = merged_groups(state)
    out = None
    if mode != CLOSE_RESET:
        out = torch.empty((P, 2 + lattice.out_rows(spec), Kl * state.n_key),
                          dtype=torch.int32, device=groups[0][0])
    for dev, ks in groups:
        with on(dev):
            by_key, back = [], []
            for k in ks:
                parts, b = _gather(state.key_shard(k), dev)
                by_key.append(parts)
                back.extend(b)
            m, tab = _merged_close_args(spec, by_key, mode, dev)
            m.c.n_sel = P
            keep = [tab]
            if P <= kb.CLOSE_INLINE:
                m.c.sel[:P] = [int(x) for x in slots]
            else:
                keep.append(torch.from_numpy(np.asarray(slots, np.int32))
                            .to(dev))
                m.c.slots = kb.ptr(keep[-1])
            dst = out
            if out is not None and len(groups) > 1:
                dst = torch.empty((P, out.shape[1], Kl * len(ks)),
                                  dtype=torch.int32, device=dev)
            if dst is not None:
                m.c.out = dst.data_ptr()
            stream = torch.cuda.current_stream(dev).cuda_stream
            if mode == CLOSE_EXTRACT_RESET:
                m.c.done = lattice._close_done(dev, stream,
                                               P * len(ks)).data_ptr()
            kb.check(kb.lib().hs_close_merged(ctypes.byref(m), stream),
                     "merged_close")
            CARD_LAUNCHES["close_merged"] += 1
            if dst is not out:
                for g, j in _key_cols(ks, Kl):
                    out[:, :, g] = dst[:, :, j].to(out.device)
            _put_back(back)
    return out


def close_merged(spec: LatticeSpec, state: ShardedState, slots,
                 mode: int = CLOSE_EXTRACT_RESET) -> torch.Tensor | None:
    """The merged close of the padded slot vector (host int32 [P], < 0 =
    padding) over every partial, one launch a card: CLOSE_EXTRACT_RESET
    returns [P, 2+rows, K] with the key shards' columns in global key
    order and resets the slots in every partial; CLOSE_EXTRACT only
    extracts (peek); CLOSE_RESET only resets. `spec` is the local spec
    (Kl keys). The merged close kernel on the card, close_merged_ref on
    the CPU."""
    slots = lattice._checked_slots(spec, slots, mode)
    if _device(state[0][0]).type == "cpu":
        return close_merged_ref(spec, state, slots, mode)
    out = _close_merged_cuda(spec, state, slots, mode)
    close_merged.launches += 1
    return out


close_merged.launches = 0  # wrapper calls that launched the kernel


def close_slot_merged_ref(spec: LatticeSpec, state: ShardedState, slot: int,
                          mode: int) -> torch.Tensor | None:
    """Plain per-slot merged close: extract ([2+rows, K]) or reset one
    slot (lattice.extract_slot_ref / reset_slot_ref over the partials)."""
    if mode == CLOSE_RESET:
        for row in state:
            for part in row:
                lattice.reset_slot_ref(spec, part, slot)
        return None
    bufs = []
    for k in range(state.n_key):
        parts = state.key_shard(k)
        col = _merged(spec, [{n: v for n, v in p.items()
                              if n not in ("slot_start", "touched")}
                             for p in parts], lambda v: v[:, slot])
        ws = merge_planes("max", [p["slot_start"][slot] for p in parts])
        bufs.append(lattice.pack_extract_rows(
            spec, col["count"], ws, lattice.finalize_column(spec, col)))
    return torch.cat(bufs, dim=1)


def close_slot_merged(spec: LatticeSpec, state: ShardedState, slot,
                      mode: int) -> torch.Tensor | None:
    """The per-slot merged close, CLOSE_EXTRACT ([2+rows, K]) or
    CLOSE_RESET, one launch of hs_close_slot_merged a card;
    close_slot_merged_ref on the CPU."""
    if mode not in (CLOSE_EXTRACT, CLOSE_RESET):
        raise ValueError("the per-slot close extracts or resets")
    slot = lattice._one_slot(spec, slot)
    if _device(state[0][0]).type == "cpu":
        return close_slot_merged_ref(spec, state, slot, mode)
    out = None
    Kl = spec.n_keys
    groups = merged_groups(state)
    if mode == CLOSE_EXTRACT:
        out = torch.empty((2 + lattice.out_rows(spec), Kl * state.n_key),
                          dtype=torch.int32, device=groups[0][0])
    for dev, ks in groups:
        with on(dev):
            by_key, back = [], []
            for k in ks:
                parts, b = _gather(state.key_shard(k), dev)
                by_key.append(parts)
                back.extend(b)
            m, _tab = _merged_close_args(spec, by_key, mode, dev)
            m.c.n_sel, m.c.slot = 1, slot
            dst = out
            if out is not None and len(groups) > 1:
                dst = torch.empty((out.shape[0], Kl * len(ks)),
                                  dtype=torch.int32, device=dev)
            if dst is not None:
                m.c.out = dst.data_ptr()
            kb.check(kb.lib().hs_close_slot_merged(
                ctypes.byref(m), torch.cuda.current_stream(dev).cuda_stream),
                "merged_close_slot")
            CARD_LAUNCHES["close_slot_merged"] += 1
            if dst is not out:
                for g, j in _key_cols(ks, Kl):
                    out[:, g] = dst[:, j].to(out.device)
            _put_back(back)
    close_slot_merged.launches += 1
    return out


close_slot_merged.launches = 0  # wrapper calls that launched the kernel


# ---- the merged changelog extract --------------------------------------------


def touched_merged_ref(spec: LatticeSpec, state: ShardedState,
                       max_out: int) -> torch.Tensor:
    """Plain merged changelog extract -> [n_key, 3+rows, max_out]: each
    key shard's lattice merged over its partials, extracted as
    lattice.extract_touched_ref does, its key ids made global (+ k * Kl,
    the fill's too); `touched` cleared in every partial."""
    bufs = []
    for k in range(state.n_key):
        parts = state.key_shard(k)
        packed = lattice.extract_touched_ref(spec, _merged(spec, parts),
                                             max_out)
        packed[1] += k * spec.n_keys
        bufs.append(packed)
        for p in parts:
            p["touched"].zero_()
    return torch.stack(bufs)


def _place_touched(out: torch.Tensor, buf: torch.Tensor, ks: list[int],
                   Kl: int) -> None:
    """A launch's buffers [len(ks), rows, max_out] (launch-local key ids:
    key shard j of the launch from j * Kl) into out[k], ids made
    global."""
    for j, k in enumerate(ks):
        b = buf[j].clone()
        b[1] += (k - j) * Kl
        out[k] = b.to(out.device)


def touched_merged_launches_ref(spec: LatticeSpec, state: ShardedState,
                                max_out: int) -> torch.Tensor:
    """Plain model of touched_merged's launches: each launch of
    merged_groups computes its key shards' buffers as touched_merged_ref
    does over them alone (launch-local key ids), placed as the wrapper
    places them. The tests hold it against the reference; nothing on the
    card's path calls it."""
    out = torch.empty((state.n_key, 3 + lattice.out_rows(spec), max_out),
                      dtype=torch.int32)
    for _dev, ks in merged_groups(state):
        sub = ShardedState([[row[k] for k in ks] for row in state])
        _place_touched(out, touched_merged_ref(spec, sub, max_out), ks,
                       spec.n_keys)
    return out


def touched_merged(spec: LatticeSpec, state: ShardedState,
                   max_out: int) -> torch.Tensor:
    """The merged changelog extract: every (key, slot) cell touched in any
    partial since the last call, finalized from the merged cell, packed
    one buffer a key shard [n_key, 3+rows, max_out] with global key ids,
    and `touched` cleared in every partial: one call of hs_touched_merged
    a launch of merged_groups (one kernel where a key shard's cells fit
    one block, lattice.touched_plan of the local spec; else a scan, a
    finalize and, with sketches, their pass), touched_merged_ref on the
    CPU."""
    if _device(state[0][0]).type == "cpu":
        return touched_merged_ref(spec, state, max_out)
    groups = merged_groups(state)
    rows = 3 + lattice.out_rows(spec)
    out = torch.empty((state.n_key, rows, max_out), dtype=torch.int32,
                      device=groups[0][0])
    n_cells = spec.n_keys * spec.n_slots
    mode = lattice.touched_plan(spec, max_out)
    for dev, ks in groups:
        with on(dev):
            by_key, back = [], []
            for k in ks:
                parts, b = _gather(state.key_shard(k), dev)
                by_key.append(parts)
                back.extend(b)
            m = kb.MergedTouchedArgs()
            t = m.t
            t.n_keys, t.n_slots = spec.n_keys, spec.n_slots
            t.max_out, t.out_rows, t.mode = max_out, rows, mode
            t.f = lattice._finalize_args(spec, by_key[0][0])
            m.parts, _tab = _parts_args(spec, by_key, dev)
            dst = out if len(groups) == 1 else torch.empty(
                (len(ks), rows, max_out), dtype=torch.int32, device=dev)
            t.out = dst.data_ptr()
            stream = torch.cuda.current_stream(dev).cuda_stream
            if mode == kb.TOUCHED_ONE:
                t.ticket = lattice._close_done(dev, stream,
                                               len(ks)).data_ptr()
            else:
                scratch = torch.empty(
                    kb.lib().hs_touched_merged_scratch_bytes(
                        n_cells, max_out, rows, len(ks)),
                    dtype=torch.uint8, device=dev)
                t.scratch = scratch.data_ptr()
            kb.check(kb.lib().hs_touched_merged(ctypes.byref(m), stream),
                     "merged_touched")
            CARD_LAUNCHES["touched_merged"] += 1
            if dst is not out:
                _place_touched(out, dst, ks, spec.n_keys)
            _put_back(back)
    touched_merged.launches += 1
    return out


touched_merged.launches = 0  # wrapper calls that launched the kernel


# ---- the snapshot merge (B19d) -------------------------------------------------


def merge_partials_ref(spec: LatticeSpec, state: ShardedState
                       ) -> dict[str, torch.Tensor]:
    """Plain snapshot merge: each plane's D partials reduced by its monoid
    and the key shards concatenated -> the canonical single-card state
    [K, W, ...] (slot_start [W] from key shard 0's partials, which every
    key shard keeps alike)."""
    kinds = plane_merge_kinds(spec)
    out = {}
    for name in state[0][0]:
        if name == "slot_start":
            out[name] = merge_planes(kinds[name],
                                     [p[name] for p in state.key_shard(0)])
            continue
        out[name] = torch.cat([
            merge_planes(kinds[name], [p[name] for p in state.key_shard(k)])
            for k in range(state.n_key)])
    return out


_MERGE_KIND = {"sum": kb.MERGE_SUM, "min": kb.MERGE_MIN,
               "max": kb.MERGE_MAX}
# the merges the kernel takes a type, those of the lattice's planes
# (lattice.plane_merge_kinds): counts and bins add, slot_start, HLL
# registers and the flags take the max, float32 accumulators any
_MERGES = {kb.MERGE_I32: (kb.MERGE_SUM, kb.MERGE_MAX),
           kb.MERGE_F32: (kb.MERGE_SUM, kb.MERGE_MIN, kb.MERGE_MAX),
           kb.MERGE_I8: (kb.MERGE_MAX,), kb.MERGE_U8: (kb.MERGE_MAX,)}
_merge_tables: dict = {}


def merge_plan(spec: LatticeSpec, by_key: list[list[dict]]
               ) -> list[kb.MergeSeg]:
    """The snapshot merge's segments (csrc/hs_kernels.h HsMergeSeg), one
    a (plane, key shard) in the order of the partials' planes and of the
    key shards, slot_start one of key shard 0: key shard s's part of a
    plane at out_off s * its bytes in the canonical plane, its blocks
    after the segments' before it, one a HS_MERGE_CHUNKS 16-byte chunks;
    16-byte chunks where every source and the output
    offset are 16-byte aligned (the output plane is)."""
    kinds = plane_merge_kinds(spec)
    index = {name: i for i, name in _plane_slots(spec)}
    segs, block = [], 0
    for name in by_key[0][0]:
        dtype = kb.MERGE_DTYPES[by_key[0][0][name].dtype]
        kind = _MERGE_KIND[kinds[name]]
        if kind not in _MERGES[dtype]:
            raise ValueError(f"plane {name}: no {kinds[name]} merge of "
                             f"{by_key[0][0][name].dtype}")
        for s in [0] if name == "slot_start" else range(len(by_key)):
            x = by_key[s][0][name]
            nbytes = x.numel() * x.element_size()
            if nbytes == 0:
                continue
            off = s * nbytes
            vec = off % 16 == 0 and all(
                _addr(p[name]) % 16 == 0 for p in by_key[s])
            segs.append(kb.MergeSeg(nbytes, off, block, index[name], s,
                                    kind, dtype, int(vec)))
            block += _merge_blocks(nbytes)
    return segs


def _merge_blocks(nbytes: int) -> int:
    """A segment's blocks: one a HS_MERGE_CHUNKS 16-byte chunks."""
    chunks = -(-nbytes // 16)
    return -(-chunks // kb.MERGE_CHUNKS)


def _segment_blocks(segs: list[kb.MergeSeg]) -> list[int]:
    """Each block's segment (segment j's blocks from its block0 on)."""
    return [j for j, sg in enumerate(segs)
            for _ in range(_merge_blocks(sg.bytes))]


def merge_segments(spec: LatticeSpec, by_key: list[list[dict]],
                   dev: torch.device, key: tuple[int, ...]
                   ) -> tuple[torch.Tensor, int, int]:
    """The snapshot merge's segment table on `dev`: (the buffer, whose
    first n_seg * sizeof(HsMergeSeg) bytes are the segments and the rest
    each block's segment as int32, n_seg, n_blocks). Cached a card and
    uploaded only where the partial table's key (the planes' addresses,
    `key`) or a plane's size changed; merge_segments.uploads counts the
    uploads."""
    sizes = tuple((name, tuple(v.shape), v.dtype)
                  for name, v in by_key[0][0].items())

    def build():
        merge_segments.uploads += 1
        segs = merge_plan(spec, by_key)
        blocks = _segment_blocks(segs)
        raw = bytes((kb.MergeSeg * len(segs))(*segs)) + \
            np.asarray(blocks, np.int32).tobytes()
        host = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        return _upload(host, dev), len(segs), len(blocks)

    return _cached(_merge_tables, dev, (key, sizes), build)


merge_segments.uploads = 0


def merge_plan_ref(spec: LatticeSpec, state: ShardedState
                   ) -> dict[str, torch.Tensor]:
    """Plain model of the snapshot merge's launch: merge_plan's segments
    and _segment_blocks' blocks run on the partials' bytes as the kernel
    runs them (a block's 16-byte chunks of its segment), into the
    canonical planes. The tests hold it against merge_partials_ref;
    nothing on the card's path calls it."""
    kinds = plane_merge_kinds(spec)
    by_key = [state.key_shard(k) for k in range(state.n_key)]
    segs = merge_plan(spec, by_key)
    names = {i: name for i, name in _plane_slots(spec)}
    out = {name: torch.empty(
        (v.shape[0] if name == "slot_start" else v.shape[0] * state.n_key,)
        + tuple(v.shape[1:]), dtype=v.dtype)
        for name, v in state[0][0].items()}
    blocks = _segment_blocks(segs)
    for b, j in enumerate(blocks):
        sg = segs[j]
        name = names[sg.plane]
        lo = (b - sg.block0) * kb.MERGE_CHUNKS * 16
        hi = min(lo + kb.MERGE_CHUNKS * 16, sg.bytes)
        if lo >= hi:
            continue
        size = state[0][0][name].element_size()
        xs = [p[name].reshape(-1)[lo // size:hi // size]
              for p in by_key[sg.shard]]
        dst = out[name].reshape(-1)
        first = sg.out_off // size
        dst[first + lo // size:first + hi // size] = merge_planes(
            kinds[name], xs)
    return out


def merge_partials(spec: LatticeSpec, state: ShardedState
                   ) -> dict[str, torch.Tensor]:
    """The canonical single-card lattice of a sharded state, each plane's
    partials merged by its monoid: one shard_merge launch a capture on
    shard (0, 0)'s card over merge_segments' table (key shards on other
    cards copied there first); merge_partials_ref on the CPU. The
    snapshot's blob holds it, so a capture restores onto one card or any
    mesh."""
    _refuse_topk(spec)
    dev = _device(state[0][0])
    if dev.type == "cpu":
        return merge_partials_ref(spec, state)
    n_key = state.n_key
    with on(dev):
        by_key = [_gather(state.key_shard(k), dev)[0] for k in range(n_key)]
        key = part_table_key(spec, by_key)
        a = kb.ShardMergeArgs()
        a.parts, _tab = _parts_args(spec, by_key, dev, key)
        segs, a.n_seg, a.n_blocks = merge_segments(spec, by_key, dev, key)
        segs.record_stream(torch.cuda.current_stream(dev))
        a.seg = segs.data_ptr()
        a.block_seg = a.seg + a.n_seg * ctypes.sizeof(kb.MergeSeg)
        out = {}
        for i, name in _plane_slots(spec):
            v = by_key[0][0][name]
            out[name] = torch.empty(
                (v.shape[0] if name == "slot_start" else v.shape[0] * n_key,)
                + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
            a.out[i] = out[name].data_ptr()
        kb.check(kb.lib().hs_shard_merge(ctypes.byref(a), kb.stream_of(
            out["count"])), "shard_merge")
    merge_partials.launches += 1
    CARD_LAUNCHES["merge_partials"] += 1
    return {name: out[name] for name in state[0][0]}


merge_partials.launches = 0  # wrapper calls that launched the kernel


def scatter_state(spec: LatticeSpec, mesh, canonical: Mapping[str, np.ndarray]
                  ) -> ShardedState:
    """A canonical (merged) lattice installed into a mesh: data shard 0's
    partials take its key ranges, the other data shards the merge
    identities, so their merge at every drain point is the canonical
    lattice (engine/snapshot.py:338 _scatter_state). `spec` is the local
    spec; planes the spec does not have (an older format's) are dropped."""
    D, nk = mesh.shape["data"], mesh.shape["key"]
    Kl = spec.n_keys
    rows = ShardedState()
    for d in range(D):
        row = []
        for k in range(nk):
            dev = mesh.devices[d, k]
            part = lattice.init_state(spec, dev)
            if d == 0:
                for name, v in part.items():
                    src = np.asarray(canonical[name])
                    if name != "slot_start":
                        src = src[k * Kl:(k + 1) * Kl]
                    v.copy_(torch.from_numpy(np.ascontiguousarray(src)))
            row.append(part)
        rows.append(row)
    return rows


# ---- the bundle ----------------------------------------------------------------


class ShardedLattice:
    """The lattice of one query over a (data, key) mesh: the reference's
    CompiledLattice callables with their signatures (state first; the
    port's update the partials in place and return the state they were
    given). `spec.n_keys` is the GLOBAL key capacity, which the key axis
    must divide; TOPK planes are refused, as the reference refuses them."""

    def __init__(self, spec: LatticeSpec, schema, filter_expr, max_out: int,
                 mesh, layout):
        self.layout = layout
        self.mesh = mesh
        self.n_data, self.n_key = mesh.shape["data"], mesh.shape["key"]
        if spec.n_keys % self.n_key != 0:
            raise ValueError(
                f"global key capacity {spec.n_keys} not divisible by "
                f"key-axis size {self.n_key}")
        self.spec = spec
        self.local_spec = LatticeSpec(
            n_keys=spec.n_keys // self.n_key, window=spec.window,
            aggs=spec.aggs, hll=spec.hll, qcfg=spec.qcfg,
            track_touched=spec.track_touched)
        self.max_out = max_out
        _refuse_topk(spec)
        _inputs, self.null_keys = lattice.compile_agg_inputs(spec, schema)
        self._progs = lattice.step_programs(self.local_spec, schema,
                                            filter_expr)
        self.devices = mesh.devices
        # per data shard: [(device, [key shard ...])] for the step, a
        # card's key shards cut into block unpacks of at most
        # kb.UNPACK_KEYS key columns
        self._step_groups = [
            _by_card([mesh.devices[d, k] for k in range(self.n_key)],
                     kb.UNPACK_KEYS) for d in range(self.n_data)]

    def init_state(self) -> ShardedState:
        """Every partial at the merge identities (a merge of D copies of
        an identity is the identity)."""
        return ShardedState(
            [lattice.init_state(self.local_spec, self.devices[d, k])
             for k in range(self.n_key)] for d in range(self.n_data))

    def step(self, state: ShardedState, watermark, packed) -> ShardedState:
        """One packed batch [3 + n_cols, cap] (host numpy or tensor), cap
        a multiple of n_data: data shard d folds records [d * cap / D,
        (d + 1) * cap / D) into each of its key shards' partials, with no
        merge (the reference's step_local under shard_map)."""
        host = torch.as_tensor(np.ascontiguousarray(packed, np.int32))
        cap = host.shape[1]
        if cap % self.n_data:
            raise ValueError(f"batch capacity {cap} not divisible by the "
                             f"data axis {self.n_data}")
        B = cap // self.n_data
        Kl = self.local_spec.n_keys
        wm = int(watermark)
        packed_on: dict = {}
        for d in range(self.n_data):
            for dev, ks in self._step_groups[d]:
                pk = packed_on.get(dev)
                if pk is None:
                    pk = packed_on[dev] = host.to(dev)
                with on(dev):
                    keys, ts, valid, cols = unpack_block(
                        pk, d * B, B, self.layout, self.null_keys,
                        [k * Kl for k in ks])
                    eval_programs(self._progs, cols, valid)
                    for j, k in enumerate(ks):
                        lattice.scatter_step(self.local_spec, state[d][k],
                                             wm, keys[j], ts, valid, cols)
        return state

    def extract_slot(self, state: ShardedState, slot) -> torch.Tensor:
        return close_slot_merged(self.local_spec, state, slot, CLOSE_EXTRACT)

    def reset_slot(self, state: ShardedState, slot) -> ShardedState:
        close_slot_merged(self.local_spec, state, slot, CLOSE_RESET)
        return state

    def extract_reset_slots(self, state: ShardedState, slots):
        return state, close_merged(self.local_spec, state, slots,
                                   CLOSE_EXTRACT_RESET)

    def extract_slots(self, state: ShardedState, slots) -> torch.Tensor:
        return close_merged(self.local_spec, state, slots, CLOSE_EXTRACT)

    def reset_slots(self, state: ShardedState, slots) -> ShardedState:
        close_merged(self.local_spec, state, slots, CLOSE_RESET)
        return state

    def extract_touched(self, state: ShardedState):
        return state, touched_merged(self.local_spec, state, self.max_out)


# ---- the key-sharded session arena (B19c) -------------------------------------
#
# The reference's ShardedSessionLattice (parallel/lattice.py:617-784): a
# session never spans keys, so each key shard keeps its own (code, t0)-
# sorted arena of the codes with code mod n_shards == shard, on the card
# of its data-0 shard (data replicas compute the same arena in the
# reference; the port keeps one). The step and merge launch once a card
# over a table of the shards whose arenas lie there (csrc/session_chain.cuh
# core_group): each record of the batch is keyed once on the card, sorted
# once where a shard of the table owns it (the others, as the reference's
# cleared valid bit or rewritten segment code makes them, are dropped
# before the sort), and folded into its own shard's arena; a table past
# what one launch takes by value splits (session_groups). An arena holds
# only codes its shard owns (put_arena places them so, steps fold only
# owned records, remaps keep residues). No collective anywhere. The
# extract launches once a card over a table of its shards too
# (csrc/session_extract.cu hs_session_extract_table); the remap once a
# shard.

Arenas = list[dict[str, torch.Tensor]]


def key_shard_devices(mesh) -> list[torch.device]:
    """The card of each key shard's data-0 shard, where its session arena
    or join stores live."""
    return [mesh.devices[0, k] for k in range(mesh.shape["key"])]


def _on_device(x: torch.Tensor, dev: torch.device,
               cache: dict | None = None) -> torch.Tensor:
    """`x` on `dev`; with a `cache` (held by the caller, with `x` alive for
    as long) copied once per device."""
    if x.device == dev:
        return x
    if cache is None:
        return x.to(dev)
    key = (id(x), dev)
    if key not in cache:
        cache[key] = x.to(dev)
    return cache[key]


def session_groups(devices: list[torch.device],
                   n_planes: int) -> list[tuple[torch.device, list[int]]]:
    """The launches of a sharded session step or merge: (card, key shards)
    for the shards whose arenas lie on each card (devices[s] is shard s's),
    in shard order, one table a card, cut where it would pass what one
    launch takes by value (kb.SESS_GROUP shards, kb.SESS_GROUP_PTRS
    plane pointer sets: 14 shards of a 64-plane query)."""
    return _by_card(devices, min(kb.SESS_GROUP,
                                 kb.SESS_GROUP_PTRS // max(n_planes, 1)))


def sharded_chain_slots_ref(code: torch.Tensor, start: torch.Tensor,
                            end: torch.Tensor, shards: list[int],
                            n_shards: int, cap: int, gap: int
                            ) -> torch.Tensor:
    """The chain assignment of one table launch (csrc/session_chain.cuh
    core_group) in plain PyTorch: the tests hold it against the
    reference's per-shard _session_chain_slots; nothing on the card's
    path calls it. The entries are the table's arenas, shard by shard
    (`cap` rows each, their times already retired and shifted), then the
    batch; an entry is live where 0 <= code < 2^22 (the caller makes dead
    rows and invalid records the sentinel). A batch entry belongs to shard
    code mod n_shards and is dropped unless that shard is in `shards`;
    every entry kept is keyed once by ((g << qbits) | code div n_shards,
    start), g its shard's place in `shards`, and sorted once; a chain's
    slot is its chain id less the chains of the shards before it, cap
    (dropped) from its shard's cap on. Returns each entry's slot. Equal
    keys are taken in the order of their ends, as the reference's sort
    takes them; the kernel's sort takes them in any order, which gives
    the same chains unless a running end lies within `gap` of 2^31
    (ROADMAP C)."""
    code, start, end = code.long(), start.long(), end.long()
    m, n_group = code.shape[0], len(shards)
    rows = n_group * cap
    i = torch.arange(m)
    pos = torch.full((n_shards,), -1, dtype=torch.long)
    pos[torch.tensor(shards, dtype=torch.long)] = torch.arange(n_group)
    live = (code >= 0) & (code < sl.SESSION_SENT_CODE)
    g = torch.where(i < rows, i // max(cap, 1),
                    pos[torch.remainder(code, n_shards)])
    keep = torch.nonzero(live & (g >= 0)).flatten()
    sort_code = (g << sl.session_qbits(n_shards)) | (code // n_shards)
    order = keep[torch.argsort(end[keep], stable=True)]
    order = order[torch.argsort(start[order], stable=True)]
    order = order[torch.argsort(sort_code[order], stable=True)]
    sc, st, en, gs = sort_code[order], start[order], end[order], g[order]
    newrun = torch.ones_like(sc, dtype=torch.bool)
    newrun[1:] = sc[1:] != sc[:-1]
    # the running max of end within each code's run: runs ascend, so one
    # cummax over (run << 33) + end + 2^31 resets at each run
    run = torch.cumsum(newrun.long(), 0) - 1
    off = (run << 33) + (1 << 31)
    runmax = torch.cummax(en + off, 0).values - off
    prev = torch.roll(runmax, 1) + gap
    prev = torch.remainder(prev + (1 << 31), 1 << 32) - (1 << 31)
    brk = newrun | (st > prev)
    cid = torch.cumsum(brk.long(), 0) - 1
    chains = torch.bincount(gs[brk], minlength=n_group)
    first = torch.cumsum(chains, 0) - chains
    local = cid - first[gs]
    dest = torch.full((m,), cap, dtype=torch.long)
    dest[order] = torch.where(local < cap, local, torch.full_like(local, cap))
    return dest


def sharded_session_step_ref(spec, arenas: Arenas, outs: Arenas,
                             packed: torch.Tensor, inputs, gap: int,
                             close_cut: int, delta: int) -> None:
    """Plain sharded record-mode step (parallel/lattice.py:669-688): each
    shard's step with the valid bit (flags bit 0) of the records other
    shards own cleared."""
    S = len(arenas)
    for s in range(S):
        p = packed.clone()
        own = torch.remainder(packed[0], S) == s
        p[2] = torch.where(own, packed[2], packed[2] & ~1)
        sl.session_step_ref(spec, arenas[s], outs[s], p, inputs, gap,
                            close_cut, delta)


def sharded_session_step(spec, arenas: Arenas, outs: Arenas,
                         packed: torch.Tensor, inputs, gap: int,
                         close_cut: int, delta: int) -> None:
    """One record-mode micro-batch on every key shard: shard s folds its
    arena and the records it owns into outs[s]. On the card the session
    step kernels once a card over a table of its shards (session_groups),
    the batch copied to each card once; sharded_session_step_ref on the
    CPU."""
    if packed.device.type == "cpu":
        sharded_session_step_ref(spec, arenas, outs, packed, inputs, gap,
                                 close_cut, delta)
        return
    S = len(arenas)
    cache: dict = {}
    for dev, shards in session_groups([a["code"].device for a in arenas],
                                      sl.n_planes(spec)):
        with on(dev):
            ins = tuple(None if v is None else _on_device(v, dev, cache)
                        for v in inputs)
            sl.step_group_cuda(spec, arenas, outs, shards, S,
                               _on_device(packed, dev, cache), ins, gap,
                               close_cut, delta)
    sharded_session_step.launches += 1


sharded_session_step.launches = 0  # wrapper calls that launched the kernels


def sharded_session_merge_ref(spec, arenas: Arenas, outs: Arenas, seg,
                              gap: int, close_cut: int, delta: int) -> None:
    """Plain sharded segment-mode merge (parallel/lattice.py:690-714):
    each shard's merge with the segment codes other shards own rewritten
    to the sentinel."""
    S = len(arenas)
    code = seg["code"]
    for s in range(S):
        own = (torch.remainder(code, S) == s) & (code < sl.SESSION_SENT_CODE)
        sg = dict(seg)
        sg["code"] = torch.where(own, code, sl.SESSION_SENT_CODE)
        sl.session_merge_ref(spec, arenas[s], outs[s], sg, gap, close_cut,
                             delta)


def sharded_session_merge(spec, arenas: Arenas, outs: Arenas, seg, gap: int,
                          close_cut: int, delta: int) -> None:
    """One segment-mode micro-batch on every key shard: the session merge
    kernels once a card over a table of its shards on the card (as
    sharded_session_step), sharded_session_merge_ref on the CPU."""
    if seg["code"].device.type == "cpu":
        sharded_session_merge_ref(spec, arenas, outs, seg, gap, close_cut,
                                  delta)
        return
    S = len(arenas)
    cache: dict = {}
    for dev, shards in session_groups([a["code"].device for a in arenas],
                                      sl.n_planes(spec)):
        with on(dev):
            sg = {k: _on_device(v, dev, cache) for k, v in seg.items()}
            sl.merge_group_cuda(spec, arenas, outs, shards, S, sg, gap,
                                close_cut, delta)
    sharded_session_merge.launches += 1


sharded_session_merge.launches = 0  # wrapper calls that launched the kernels


def sharded_session_extract_ref(spec, arenas: Arenas,
                                slots: np.ndarray) -> torch.Tensor:
    """Plain sharded extract (parallel/lattice.py:716-728): shard s's
    slot list slots[s] finalized -> [n_shards, 1 + n_aggs, pcap]."""
    return torch.stack([
        sl.session_extract_ref(spec, a, torch.from_numpy(
            np.ascontiguousarray(slots[s])).to(a["code"].device))
        for s, a in enumerate(arenas)])


def extract_tables(devices: list[torch.device]) -> Tables:
    """The table launches of a sharded session extract: (card, key
    shards) for the shards whose arenas lie on each card (devices[s] is
    shard s's), one table a card, cut past kb.SESS_XT_SHARDS shards."""
    return _by_card(devices, kb.SESS_XT_SHARDS)


def extract_plan(slots: np.ndarray, shards: list[int]
                 ) -> tuple[list[int], list[int], np.ndarray]:
    """A table's slot lists (host int32 [n_shards, pcap], < 0 = padding):
    each shard's named prefix (up to its last named slot), the prefix's
    first entry in the table's list, and the prefixes concatenated."""
    n_live = []
    for s in shards:
        named = np.flatnonzero(slots[s] >= 0)
        n_live.append(int(named[-1]) + 1 if len(named) else 0)
    sel0 = np.concatenate([[0], np.cumsum(n_live)[:-1]]).astype(int)
    cat = np.concatenate([slots[s, :n] for s, n in zip(shards, n_live)]
                         + [np.zeros(0, np.int32)]).astype(np.int32)
    return n_live, [int(x) for x in sel0], cat


def extract_pieces(n_live: list[int], P: int
                   ) -> list[tuple[int, int, int]]:
    """A table's grid rows: (place of the shard, first warp, warps) pieces
    of the shards' warps (a warp an entry of the named prefix, then one
    each 32 pad columns), each at most ceil(total / (32 - G)) long, so at
    most kb.SESS_XT_PIECES of them however the named slots fall among the
    shards."""
    warps = [n + -(-(P - n) // 32) for n in n_live]
    per = max(1, -(-sum(warps) // (kb.SESS_XT_PIECES - len(warps))))
    return [(g, j0, min(per, w - j0)) for g, w in enumerate(warps)
            for j0 in range(0, w, per)]


def sharded_session_extract_table_ref(spec, arenas: Arenas,
                                      slots: np.ndarray) -> torch.Tensor:
    """Plain sharded extract as the table launches compute it: each
    table's prefixes concatenated (extract_plan) and its warps cut into
    pieces (extract_pieces), each piece's columns (an entry of its shard's
    prefix a warp, then 32 pad columns a warp) gathered into its shard's
    slot vector, every column once; the shards' rows from those. The tests
    hold it against the reference; nothing on the card's path calls it."""
    P = slots.shape[1]
    out: list = [None] * len(arenas)
    for _dev, shards in extract_tables([a["code"].device for a in arenas]):
        n_live, sel0, cat = extract_plan(slots, shards)
        vecs = [np.full(P, -2, np.int32) for _ in shards]
        for g, j0, nw in extract_pieces(n_live, P):
            for j in range(j0, j0 + nw):
                if j < n_live[g]:
                    vecs[g][j] = cat[sel0[g] + j]
                else:
                    c = n_live[g] + (j - n_live[g]) * 32
                    vecs[g][c:c + 32] = -1
        for g, s in enumerate(shards):
            if (vecs[g] == -2).any():
                raise AssertionError("extract pieces leave columns out")
            out[s] = sl.session_extract_ref(
                spec, arenas[s], torch.from_numpy(vecs[g]).to(
                    arenas[s]["code"].device))
    return torch.stack(out)


def _extract_table_args(spec, arenas: Arenas, shards: list[int],
                        slots: np.ndarray, rows: list[torch.Tensor]):
    """The table launch's argument block over `shards` (their arenas on
    one card), shard shards[g] writing rows[g] ([1 + n_aggs, P]), and the
    tensors it reads that must outlive the launch (the uploaded
    prefixes, where they do not fit beside the pointers)."""
    G, A, P = len(shards), len(spec.aggs), slots.shape[1]
    if not 1 <= G <= kb.SESS_XT_SHARDS or A > kb.MAX_AGGS:
        raise ValueError(f"an extract table of {G} shards does not fit a "
                         f"launch")
    cap = arenas[shards[0]]["code"].shape[0]
    dev = arenas[shards[0]]["code"].device
    t = kb.SessExtractTable()
    t.cap, t.n_sel, t.n_group = cap, P, G
    sl.extract_finalize(spec, arenas[shards[0]], t.f)
    n_live, sel0, cat = extract_plan(slots, shards)
    base = kb.SessExtractTable.words.offset
    words = (ctypes.c_uint64 * (2 * G * A)).from_address(
        ctypes.addressof(t) + base)
    names = sl.session_plane_names(spec)
    for g, s in enumerate(shards):
        a = arenas[s]
        sl._check_arena(spec, a, cap, dev)
        for i, (name, agg) in enumerate(zip(names, spec.aggs)):
            words[2 * (g * A + i)] = kb.ptr(a[name])
            if agg.kind == AggKind.AVG:
                words[2 * (g * A + i) + 1] = kb.ptr(a[name + "_n"])
    keep = []
    inline = 4 * G * A + len(cat) <= kb.SESS_XT_WORDS
    if inline:   # the prefixes in the words, after the pointers
        ctypes.memmove(ctypes.addressof(t) + base + 16 * G * A,
                       cat.ctypes.data, cat.nbytes)
    else:
        keep.append(torch.from_numpy(cat).to(dev))
        t.slots = kb.ptr(keep[-1])
    pieces = extract_pieces(n_live, P)
    t.n_pieces = len(pieces)
    for r, (g, j0, nw) in enumerate(pieces):
        pc = t.pc[r]
        pc.code = kb.ptr(arenas[shards[g]]["code"])
        pc.out = kb.ptr(rows[g])
        pc.place, pc.n_live, pc.j0, pc.n_warps = g, n_live[g], j0, nw
        pc.sel0 = sel0[g] + (4 * G * A if inline else 0)
    return t, keep


def sharded_session_extract(spec, arenas: Arenas, slots) -> torch.Tensor:
    """Finalized rows of the per-shard slot lists `slots` (host int32
    [n_shards, pcap], < 0 = padding) -> int32 [n_shards, 1 + n_aggs,
    pcap] on shard 0's card, read-only: the session extract's table
    kernel once a card over the shards whose arenas lie there
    (extract_tables; a shard on another card writes its row there, copied
    in); sharded_session_extract_ref on the CPU."""
    slots = np.asarray(slots, np.int32)
    if slots.ndim != 2 or slots.shape[0] != len(arenas):
        raise ValueError("sharded session extract: slots must be "
                         "[n_shards, pcap]")
    cap = arenas[0]["code"].shape[0]
    if (slots >= cap).any():
        raise ValueError("sharded session extract: slot index out of range")
    dev0 = arenas[0]["code"].device
    if dev0.type == "cpu":
        return sharded_session_extract_ref(spec, arenas, slots)
    if spec.hll.precision < 2:
        raise ValueError("sharded session extract: unsupported spec")
    shape = (1 + len(spec.aggs), slots.shape[1])
    out = torch.empty((len(arenas),) + shape, dtype=torch.int32,
                      device=dev0)
    for dev, shards in extract_tables([a["code"].device for a in arenas]):
        with on(dev):
            dst = out if dev == dev0 else torch.empty(
                (len(shards),) + shape, dtype=torch.int32, device=dev)
            rows = [dst[s] if dst is out else dst[g]
                    for g, s in enumerate(shards)]
            t, _keep = _extract_table_args(spec, arenas, shards, slots, rows)
            kb.check(kb.lib().hs_session_extract_table(
                ctypes.byref(t), kb.stream_of(dst)), "sharded_session_extract")
            if dst is not out:
                for g, s in enumerate(shards):
                    out[s] = dst[g].to(dev0)
    sharded_session_extract.launches += 1
    return out


sharded_session_extract.launches = 0  # wrapper calls that launched them


def sharded_session_remap(arenas: Arenas, lut: torch.Tensor) -> None:
    """Every shard's arena codes remapped through the one table `lut`
    (int32 [lcap]), in place (parallel/lattice.py:730-743): the remap
    kernel once a shard on the card, session_remap_ref on the CPU. The
    table must keep residues (new mod n_shards == old), so no entry
    changes owner."""
    if lut.dtype != torch.int32:
        raise ValueError("sharded session remap: lut must be int32")
    if arenas[0]["code"].device.type == "cpu":
        for a in arenas:
            sl.session_remap_ref(a, lut.to(a["code"].device))
        return
    cache: dict = {}
    for a in arenas:
        dev = a["code"].device
        with on(dev):
            sl.remap_cuda(a, _on_device(lut, dev, cache))
    sharded_session_remap.launches += 1


sharded_session_remap.launches = 0  # wrapper calls that launched them


class ShardedSessionLattice:
    """The session arena of one query, key-sharded over a mesh's key axis
    (the reference's ShardedSessionLattice, parallel/lattice.py:617-784):
    an arena is a list of per-shard plane dicts, arena[s] on key shard
    s's card. Capacities are PER SHARD. The port's programs write a fresh
    arena the caller passes (the executor's ping-pong), where the
    reference returned a new one."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.n_shards = mesh.shape["key"]
        self.spec = spec
        self.devices = key_shard_devices(mesh)

    def init_arena(self, cap: int) -> Arenas:
        """Per-shard empty arenas."""
        return [sl.init_session_arena(self.spec, cap, d)
                for d in self.devices]

    def put_arena(self, host: Mapping[str, np.ndarray]) -> Arenas:
        """Host planes [n_shards, cap, ...] -> per-shard arenas."""
        return [{k: torch.from_numpy(np.ascontiguousarray(v[s])).to(d)
                 for k, v in host.items()}
                for s, d in enumerate(self.devices)]

    def grow_arena(self, arena: Arenas, new_cap: int) -> Arenas:
        """Every shard's arena copied into a wider one (identities past
        the old capacity), as session_lattice.grow_session_arena."""
        return [sl.grow_session_arena(self.spec, a, new_cap) for a in arena]

    def step(self, arena: Arenas, out: Arenas, packed: torch.Tensor, inputs,
             gap: int, close_cut: int, delta: int) -> Arenas:
        """Record-mode micro-batch into `out`: out, no fetch."""
        sharded_session_step(self.spec, arena, out, packed, inputs, gap,
                             close_cut, delta)
        return out

    def merge(self, arena: Arenas, out: Arenas, seg, gap: int,
              close_cut: int, delta: int) -> Arenas:
        """Segment-mode micro-batch into `out`: out, no fetch."""
        sharded_session_merge(self.spec, arena, out, seg, gap, close_cut,
                              delta)
        return out

    def extract(self, arena: Arenas, slots) -> torch.Tensor:
        """Finalized rows for per-shard slot lists [n_shards, pcap] (-1
        pads) -> [n_shards, 1 + n_aggs, pcap]."""
        return sharded_session_extract(self.spec, arena, slots)

    def remap(self, arena: Arenas, lut: torch.Tensor) -> Arenas:
        """Rewrite every shard's codes through one residue-preserving
        table (compaction), in place."""
        sharded_session_remap(arena, lut)
        return arena


# ---- the key-sharded interval join (B19b) -------------------------------------
#
# The reference's ShardedJoinLattice (parallel/lattice.py:340-615): key
# shard s owns the join-key codes with code mod n_shards == s and holds
# its own slice of both side stores, on the card of its data-0 shard.
# Every batch goes to every card once. The probe and the insert run one
# launch sequence a card over a table of the shards whose stores lie
# there (join_groups): the batch's valid records are grouped once by
# owner (csrc/join_group.cu) and each shard's group is probed against
# its store and merged into it (the table entries of csrc/join_probe.cu
# and csrc/join_insert.cu). Shard s's match buffer lands in columns
# [s * match_cap, (s + 1) * match_cap) of one [rows, n_shards *
# match_cap] buffer on shard 0's card (the reference's layout, its
# header at column s * match_cap); in the fused step its match feed
# lands at entries [s * match_cap, ...) of one feed, so the reference's
# all_gather over the key axis is addressing, and one scatter a card
# over the table of the inner lattice's partials there (scatter.cu
# hs_scatter_table) routes and folds every entry. The eviction runs once
# a shard.

Stores = list[dict[str, torch.Tensor]]
Tables = list[tuple[torch.device, list[int]]]


def join_groups(devices: list[torch.device]) -> Tables:
    """The table launches of a sharded join's probe and insert: (card,
    key shards) for the shards whose stores lie on each card (devices[s]
    is shard s's), in shard order, one table a card, cut where it would
    pass what one launch takes (kb.JOIN_GROUP shards)."""
    return _by_card(devices, kb.JOIN_GROUP)


def sharded_join_probe_ref(others: Stores, batch: torch.Tensor, n: int,
                           within: int, cutoff: int, match_cap: int,
                           n_cols_mine: int) -> torch.Tensor:
    """Plain sharded probe as the reference plans it (parallel/
    lattice.py:420-439): each shard's match buffer over the records it
    owns (its owned mask over the whole batch), concatenated along the
    columns -> [rows, n_shards * match_cap]."""
    S = len(others)
    return torch.cat([
        jl.join_probe_ref(o, batch, n, within, cutoff, match_cap,
                          n_cols_mine, owned=jl.owned_mask(batch[0], (S, s)))
        for s, o in enumerate(others)], dim=1)


def sharded_join_probe_table_ref(others: Stores, batch: torch.Tensor, n: int,
                                 within: int, cutoff: int, match_cap: int,
                                 n_cols_mine: int) -> torch.Tensor:
    """Plain sharded probe as the table launches compute it: each table's
    grouping (join_lattice.group_ref), each shard probing only its
    group's records, its buffer at columns [s * match_cap, ...)."""
    S = len(others)
    parts = [None] * S
    for _dev, ks in join_groups([x["code"].device for x in others]):
        grouping = jl.group_ref(batch, n, ks, S)
        for g, s in enumerate(ks):
            parts[s] = jl.join_probe_ref(
                others[s], batch, n, within, cutoff, match_cap, n_cols_mine,
                records=jl.group_records(grouping, g))
    return torch.cat(parts, dim=1)


def sharded_join_insert_ref(mines: Stores, batch: torch.Tensor, n: int,
                            n_cols: int) -> Stores:
    """Plain sharded insert: each shard's store merged with the records
    it owns (join_lattice.owned_batch)."""
    S = len(mines)
    return [jl.join_insert_ref(m, *jl.owned_batch(batch, n, (S, s)), n_cols)
            for s, m in enumerate(mines)]


def _probe_tables(others: Stores, batch: torch.Tensor, n: int, within: int,
                  cutoff: int, match_cap: int, n_cols_mine: int, branch,
                  mines: Stores | None = None,
                  outs: Stores | None = None) -> torch.Tensor:
    """The table probe in pack mode once a card (each table's grouping
    shared with its insert, when `mines` are given), into the mesh's
    buffer on shard 0's card; a card's other than shard 0's writes its
    shards' columns of its own buffer, copied in."""
    S = len(others)
    dev0 = others[0]["code"].device
    rows = 5 + n_cols_mine + others[0]["cols"].shape[0]
    packed = torch.empty((rows, S * match_cap), dtype=torch.int32,
                         device=dev0)
    cache: dict = {}
    for dev, ks in join_groups([x["code"].device for x in others]):
        with on(dev):
            b = _on_device(batch, dev, cache)
            grouping = jl.group_cuda(b, n, ks, S)
            if dev == dev0:
                jl.probe_table_cuda(others, ks, grouping, b, n, within,
                                    cutoff, match_cap, n_cols_mine, branch,
                                    [s * match_cap for s in ks],
                                    packed=packed)
            else:
                local = torch.empty((rows, len(ks) * match_cap),
                                    dtype=torch.int32, device=dev)
                jl.probe_table_cuda(others, ks, grouping, b, n, within,
                                    cutoff, match_cap, n_cols_mine, branch,
                                    [g * match_cap for g in range(len(ks))],
                                    packed=local)
                for g, s in enumerate(ks):
                    packed[:, s * match_cap:(s + 1) * match_cap] = local[
                        :, g * match_cap:(g + 1) * match_cap].to(dev0)
            if mines is not None:
                jl.insert_table_cuda(mines, outs, ks, grouping, b, n,
                                     n_cols_mine)
    return packed


def sharded_join_probe_insert(mines: Stores, others: Stores,
                              batch: torch.Tensor, n: int, within: int,
                              cutoff: int, match_cap: int, n_cols_mine: int,
                              outs: Stores | None = None, branch=None):
    """The match-fetch path's batch on every key shard (probe_insert,
    parallel/lattice.py:394-418): (mines', packed [rows, n_shards *
    match_cap]). On the card one launch sequence a card over the table
    of its shards (join_groups): the grouping, the probe in pack mode and
    the insert writing `outs`; on the CPU the tables' plain versions."""
    if batch.device.type == "cpu":
        return (sharded_join_insert_ref(mines, batch, n, n_cols_mine),
                sharded_join_probe_table_ref(others, batch, n, within,
                                             cutoff, match_cap, n_cols_mine))
    if outs is None:
        raise ValueError("sharded join probe: the card needs out stores")
    packed = _probe_tables(others, batch, n, within, cutoff, match_cap,
                           n_cols_mine, branch, mines, outs)
    sharded_join_probe_insert.launches += 1
    return outs, packed


sharded_join_probe_insert.launches = 0  # wrapper calls that launched them


def sharded_join_probe_only(others: Stores, batch: torch.Tensor, n: int,
                            within: int, cutoff: int, match_cap: int,
                            n_cols_mine: int, branch=None) -> torch.Tensor:
    """The overflow redo on every key shard (probe_only,
    parallel/lattice.py:420-439): the grouping and the table probe in
    pack mode once a card, the tables' plain version on the CPU."""
    if batch.device.type == "cpu":
        return sharded_join_probe_table_ref(others, batch, n, within,
                                            cutoff, match_cap, n_cols_mine)
    packed = _probe_tables(others, batch, n, within, cutoff, match_cap,
                           n_cols_mine, branch)
    sharded_join_probe_only.launches += 1
    return packed


sharded_join_probe_only.launches = 0  # wrapper calls that launched them


def join_route_ref(kid: torch.Tensor, valid: torch.Tensor, n_data: int,
                   n_key: int, local_keys: int):
    """Plain routing of a concatenated match feed to the inner lattice's
    partials (parallel/lattice.py:505-515), which the table scatter
    (scatter_table) does as it reads each entry: (keys int32 [n_key, m],
    key column k = kid - k * local_keys, valid bool [n_data, m], row d the
    entries i with i mod n_data == d)."""
    m = kid.shape[0]
    k64 = kid.to(torch.int64)
    keys = torch.stack([jl._wrap32(k64 - k * local_keys)
                        for k in range(n_key)])
    mine = torch.arange(m, device=kid.device) % n_data
    return keys, torch.stack([valid & (mine == d) for d in range(n_data)])


def scatter_groups(state: ShardedState, n_aggs: int
                   ) -> list[tuple[torch.device, list[tuple[int, int]]]]:
    """The table launches of the fused step's scatter: (card, partials
    (d, k)) for the inner lattice's partials on each card, in (d, k)
    order, cut where they would pass what one launch takes
    (kb.SCATTER_TABLE partials, kb.SCATTER_TABLE_PTRS plane pointer
    sets, kb.SCATTER_PLACES consecutive partials of the mesh)."""
    per = min(kb.SCATTER_TABLE, kb.SCATTER_TABLE_PTRS // max(n_aggs, 1))
    K = state.n_key
    by_card: dict = {}
    for d in range(state.n_data):
        for k in range(K):
            by_card.setdefault(_device(state[d][k]), []).append((d, k))
    out: list = []
    for dev, ps in by_card.items():
        for d, k in ps:
            cur = out[-1][1] if out and out[-1][0] == dev else None
            if cur is None or len(cur) == per or \
                    (d - cur[0][0]) * K + k - cur[0][1] >= kb.SCATTER_PLACES:
                out.append((dev, []))
            out[-1][1].append((d, k))
    return out


def scatter_table_ref(spec: LatticeSpec, state: ShardedState, parts,
                      wm_rel: int, kid: torch.Tensor, ts: torch.Tensor,
                      valid: torch.Tensor, cols) -> None:
    """Plain table scatter (the fused step's middle, parallel/
    lattice.py:505-518): the feed routed (join_route_ref) and scattered
    into each partial (d, k) of `parts`, in place."""
    keys, vd = join_route_ref(kid, valid, state.n_data, state.n_key,
                              spec.n_keys)
    for d, k in parts:
        lattice.scatter_step_ref(spec, state[d][k], int(wm_rel), keys[k],
                                 ts, vd[d], cols)


def _scatter_aggs(spec: LatticeSpec) -> list[int]:
    return [i for i, a in enumerate(spec.aggs)
            if a.kind != AggKind.COUNT_ALL and a.kind not in
            lattice._TOPK_KINDS]


def _scatter_table_args(spec: LatticeSpec, state: ShardedState, parts,
                        aggs: list[int]) -> kb.ScatterTable:
    """A table scatter's partials: partial parts[p]'s planes in place p,
    each partial q = d * n_key + k of the mesh from the table's first,
    q0, named by its place at place[q - q0] (-1: another table's)."""
    qs = [d * state.n_key + k for d, k in parts]
    if not 1 <= len(parts) <= kb.SCATTER_TABLE or \
            len(parts) * len(aggs) > kb.SCATTER_TABLE_PTRS or \
            max(qs) - min(qs) >= kb.SCATTER_PLACES:
        raise ValueError(f"a scatter table of {len(parts)} partials does "
                         f"not fit a launch")
    t = kb.ScatterTable()
    t.n_data, t.n_key, t.n_parts = state.n_data, state.n_key, len(parts)
    t.q0, t.n_q = min(qs), max(qs) - min(qs) + 1
    t.data_div.m, t.data_div.shift = lattice.divisor(state.n_data)
    t.key_div.m, t.key_div.shift = lattice.divisor(spec.n_keys)
    for q in range(kb.SCATTER_PLACES):
        t.place[q] = -1
    for p, (d, k) in enumerate(parts):
        t.place[qs[p] - t.q0] = p
        part = state[d][k]
        t.p[p].count = kb.ptr(part["count"])
        t.p[p].slot_start = kb.ptr(part["slot_start"])
        t.p[p].touched = kb.ptr(part["touched"])
        for g, i in enumerate(aggs):
            agg = spec.aggs[i]
            name = lattice._plane_name(i, agg)
            pp = t.pp[p * len(aggs) + g]
            pp.plane = kb.ptr(part[name])
            if agg.kind == AggKind.AVG:
                pp.plane_n = kb.ptr(part[name + "_n"])
    return t


def scatter_table_cuda(spec: LatticeSpec, state: ShardedState, parts,
                       wm_rel: int, kid: torch.Tensor, ts: torch.Tensor,
                       valid: torch.Tensor, cols) -> None:
    """The table scatter's launch over the partials `parts` (on the feed's
    card): every (entry, window) of the feed read once, routed and folded
    in place (csrc/scatter.cu hs_scatter_table)."""
    aggs = _scatter_aggs(spec)
    d0, k0 = parts[0]
    args = lattice._step_args(spec, state[d0][k0], int(wm_rel), kid, ts,
                              valid, cols, aggs)
    args.mode = kb.SCATTER_GLOBAL
    args.blocks = max(1, -(-args.cap * spec.windows_per_record // 256))
    t = _scatter_table_args(spec, state, parts, aggs)
    kb.check(kb.lib().hs_scatter_table(ctypes.byref(args), ctypes.byref(t),
                                       kb.stream_of(ts)),
             "scatter_table")
    scatter_table_cuda.launches += 1


scatter_table_cuda.launches = 0  # launches of the table scatter


def _feed_columns(feed, m: int, dev: torch.device) -> dict:
    feed_plan, nulls_plan, _filter = feed
    cols = {name: torch.empty(m, dtype=jl._feed_tag(tag), device=dev)
            for name, tag, *_ref in feed_plan}
    cols.update({key: torch.empty(m, dtype=torch.bool, device=dev)
                 for key, _refs in nulls_plan})
    return cols


def _step_inner(spec, inner_state: ShardedState, wm_rel: int, kid, ts,
                valid, cols, progs, scatter) -> None:
    """The fused step's middle: the inner step's programs once over the
    whole feed, then `scatter` once a table of partials a card (the feed
    copied to each card once)."""
    eval_programs(progs, cols, valid)
    for dev, parts in scatter_groups(inner_state, len(_scatter_aggs(spec))):
        with on(dev):
            scatter(spec, inner_state, parts, int(wm_rel),
                    _on_device(kid, dev), _on_device(ts, dev),
                    _on_device(valid, dev),
                    {c: _on_device(v, dev) for c, v in cols.items()})


def sharded_join_probe_insert_step_ref(mines: Stores, others: Stores,
                                       batch: torch.Tensor, n: int,
                                       within: int, cutoff: int,
                                       match_cap: int, n_cols_mine: int,
                                       spec, inner_state: ShardedState,
                                       wm_rel: int, ts_off: int, progs,
                                       feed):
    """Plain fused sharded step as the reference plans it (parallel/
    lattice.py:470-528): every shard's match feed over the records it
    owns, concatenated; the inner step's programs over it; each partial
    (d, k) of the inner lattice scattered with its routed keys and valid
    mask (in place); then each shard's insert. Returns (mines', per-shard
    totals int32 [n_shards])."""
    S = len(others)
    parts = [jl._join_match_feed(o, batch, n, within, cutoff, match_cap,
                                 *feed, owned=jl.owned_mask(batch[0], (S, s)))
             for s, o in enumerate(others)]
    totals = torch.tensor([p[0] for p in parts], dtype=torch.int32,
                          device=batch.device)
    kid = torch.cat([p[1] for p in parts])
    ts = jl._wrap32(torch.cat([p[2] for p in parts]).to(torch.int64)
                    + ts_off)
    valid = torch.cat([p[3] for p in parts])
    cols = {k: torch.cat([p[4][k] for p in parts]) for k in parts[0][4]}
    for prog, name in progs:
        r = prog(cols)
        if name is None:
            valid = valid & r
        else:
            cols[name] = r
    keys, vd = join_route_ref(kid, valid, inner_state.n_data,
                              inner_state.n_key, spec.n_keys)
    for d in range(inner_state.n_data):
        for k in range(inner_state.n_key):
            lattice.scatter_step_ref(spec, inner_state[d][k], int(wm_rel),
                                     keys[k], ts, vd[d], cols)
    return sharded_join_insert_ref(mines, batch, n, n_cols_mine), totals


def sharded_join_probe_insert_step_table_ref(
        mines: Stores, others: Stores, batch: torch.Tensor, n: int,
        within: int, cutoff: int, match_cap: int, n_cols_mine: int, spec,
        inner_state: ShardedState, wm_rel: int, ts_off: int, progs, feed):
    """Plain fused sharded step as the table launches compute it: each
    table's grouping, each shard's feed over its group's records at
    entries [s * match_cap, ...), the programs once, the table scatter
    (scatter_table_ref) a table of partials, then each shard's insert
    of the records it owns (the group's records, in order)."""
    S = len(others)
    parts = [None] * S
    for _dev, ks in join_groups([x["code"].device for x in others]):
        grouping = jl.group_ref(batch, n, ks, S)
        for g, s in enumerate(ks):
            parts[s] = jl._join_match_feed(
                others[s], batch, n, within, cutoff, match_cap, *feed,
                records=jl.group_records(grouping, g))
    totals = torch.tensor([p[0] for p in parts], dtype=torch.int32,
                          device=batch.device)
    kid = torch.cat([p[1] for p in parts])
    ts = jl._wrap32(torch.cat([p[2] for p in parts]).to(torch.int64)
                    + ts_off)
    valid = torch.cat([p[3] for p in parts])
    cols = {k: torch.cat([p[4][k] for p in parts]) for k in parts[0][4]}
    _step_inner(spec, inner_state, wm_rel, kid, ts, valid, cols, progs,
                scatter_table_ref)
    return sharded_join_insert_ref(mines, batch, n, n_cols_mine), totals


def sharded_join_probe_insert_step(mines: Stores, others: Stores,
                                   batch: torch.Tensor, n: int, within: int,
                                   cutoff: int, match_cap: int,
                                   n_cols_mine: int, spec,
                                   inner_state: ShardedState, wm_rel: int,
                                   ts_off: int, progs, feed,
                                   outs: Stores | None = None, branch=None):
    """The fused batch on every key shard (probe_insert_step,
    parallel/lattice.py:470-528): a card's grouping and table probe in
    feed mode write its shards' segments of one feed (join_groups), the
    inner step's programs run over it once, the table scatter routes and
    folds it into the partials (one launch a card), and each card's table
    insert writes `outs`; nothing is fetched. `spec` is the inner
    lattice's local spec, `progs` its step programs. Returns (mines',
    per-shard match totals int32 [n_shards] on shard 0's card). The
    tables' plain version on the CPU."""
    if batch.device.type == "cpu":
        return sharded_join_probe_insert_step_table_ref(
            mines, others, batch, n, within, cutoff, match_cap, n_cols_mine,
            spec, inner_state, wm_rel, ts_off, progs, feed)
    if outs is None:
        raise ValueError("sharded join step: the card needs out stores")
    S = len(others)
    dev0 = others[0]["code"].device
    m = S * match_cap
    kid = torch.empty(m, dtype=torch.int32, device=dev0)
    ts = torch.empty(m, dtype=torch.int32, device=dev0)
    valid = torch.empty(m, dtype=torch.bool, device=dev0)
    cols = _feed_columns(feed, m, dev0)
    totals = torch.empty(S, dtype=torch.int32, device=dev0)
    cache: dict = {}
    for dev, ks in join_groups([x["code"].device for x in others]):
        with on(dev):
            b = _on_device(batch, dev, cache)
            grouping = jl.group_cuda(b, n, ks, S)
            if dev == dev0:
                jl.probe_table_cuda(others, ks, grouping, b, n, within,
                                    cutoff, match_cap, n_cols_mine, branch,
                                    [s * match_cap for s in ks],
                                    feed=(feed, ts_off),
                                    dest=(kid, ts, valid, cols),
                                    totals=totals)
            else:
                lm = len(ks) * match_cap
                dest = (torch.empty(lm, dtype=torch.int32, device=dev),
                        torch.empty(lm, dtype=torch.int32, device=dev),
                        torch.empty(lm, dtype=torch.bool, device=dev),
                        _feed_columns(feed, lm, dev))
                tot = torch.empty(len(ks), dtype=torch.int32, device=dev)
                jl.probe_table_cuda(others, ks, grouping, b, n, within,
                                    cutoff, match_cap, n_cols_mine, branch,
                                    [g * match_cap for g in range(len(ks))],
                                    feed=(feed, ts_off), dest=dest,
                                    totals=tot)
                for g, s in enumerate(ks):
                    at, lat = s * match_cap, g * match_cap
                    for full, part in [(kid, dest[0]), (ts, dest[1]),
                                       (valid, dest[2])] + [
                            (cols[c], dest[3][c]) for c in cols]:
                        full[at:at + match_cap] = \
                            part[lat:lat + match_cap].to(dev0)
                    totals[s:s + 1] = tot[g:g + 1].to(dev0)
            jl.insert_table_cuda(mines, outs, ks, grouping, b, n,
                                 n_cols_mine)
    with on(dev0):
        _step_inner(spec, inner_state, wm_rel, kid, ts, valid, cols, progs,
                    scatter_table_cuda)
    sharded_join_probe_insert_step.launches += 1
    return outs, totals


sharded_join_probe_insert_step.launches = 0  # wrapper calls that launched


def sharded_join_evict_ref(lefts: Stores, rights: Stores, cutoff: int,
                           delta: int):
    """Plain sharded eviction (parallel/lattice.py:441-467): each shard's
    two-sided eviction -> (lefts', rights', live counts int32
    [n_shards, 2])."""
    res = [jl.join_evict_ref(lt, rt, cutoff, delta)
           for lt, rt in zip(lefts, rights)]
    return ([r[0] for r in res], [r[1] for r in res],
            torch.stack([r[2].to(lefts[0]["code"].device) for r in res]))


def sharded_join_evict(lefts: Stores, rights: Stores, cutoff: int, delta: int,
                       outs: tuple[Stores, Stores] | None = None):
    """Eviction + epoch rebase of every key shard's two sides: (lefts',
    rights', live counts int32 [n_shards, 2] on shard 0's card, not
    fetched). The eviction kernel once a shard into the `outs` pair of
    store lists on the card, sharded_join_evict_ref on the CPU."""
    if lefts[0]["code"].device.type == "cpu":
        return sharded_join_evict_ref(lefts, rights, cutoff, delta)
    if outs is None:
        raise ValueError("sharded join evict: the card needs an out pair")
    dev0 = lefts[0]["code"].device
    counts = torch.empty((len(lefts), 2), dtype=torch.int32, device=dev0)
    for s, (lt, rt) in enumerate(zip(lefts, rights)):
        dev = lt["code"].device
        with on(dev):
            pair = (outs[0][s], outs[1][s])
            if dev == dev0:
                jl.evict_cuda(lt, rt, cutoff, delta, pair, n_out=counts[s])
            else:
                counts[s] = jl.evict_cuda(lt, rt, cutoff, delta,
                                          pair).to(dev0)
    sharded_join_evict.launches += 1
    return outs[0], outs[1], counts


sharded_join_evict.launches = 0  # wrapper calls that launched the kernels


class ShardedJoinLattice:
    """Both sides of one interval join, key-sharded over a mesh's key axis
    (the reference's ShardedJoinLattice, parallel/lattice.py:340-615): a
    side is a list of per-shard stores, store[s] on key shard s's card.
    Capacities are PER SHARD. The port's programs write the stores the
    caller passes (`out`, the executor's ping-pong; None on the CPU,
    where the plain versions return new ones)."""

    def __init__(self, mesh, n_cols_l: int, n_cols_r: int):
        self.mesh = mesh
        self.n_shards = mesh.shape["key"]
        self.n_cols = {"l": n_cols_l, "r": n_cols_r}
        self.devices = key_shard_devices(mesh)

    def init_store(self, side: str, cap: int) -> Stores:
        """Per-shard empty stores."""
        return [jl.init_join_store(cap, self.n_cols[side], d)
                for d in self.devices]

    def empty_store(self, side: str, cap: int) -> Stores:
        """Per-shard uninitialized stores, for the kernels to write."""
        return [jl.empty_join_store(cap, self.n_cols[side], d)
                for d in self.devices]

    def put_store(self, host: Mapping[str, np.ndarray]) -> Stores:
        """Host planes [n_shards, cap] ([n_shards, n_cols, cap] for cols)
        -> per-shard stores."""
        return [{k: torch.from_numpy(np.ascontiguousarray(v[s])).to(d)
                 for k, v in host.items()}
                for s, d in enumerate(self.devices)]

    def probe_insert(self, side: str, mine: Stores, other: Stores,
                     batch: torch.Tensor, n: int, within: int, cutoff: int,
                     match_cap: int, out: Stores | None = None):
        return sharded_join_probe_insert(mine, other, batch, n, within,
                                         cutoff, match_cap,
                                         self.n_cols[side], outs=out)

    def probe_only(self, side: str, other: Stores, batch: torch.Tensor,
                   n: int, within: int, cutoff: int,
                   match_cap: int) -> torch.Tensor:
        return sharded_join_probe_only(other, batch, n, within, cutoff,
                                       match_cap, self.n_cols[side])

    def probe_insert_step(self, side: str, inner: ShardedLattice,
                          mine: Stores, other: Stores, batch: torch.Tensor,
                          n: int, within: int, cutoff: int,
                          inner_state: ShardedState, wm_rel: int,
                          ts_off: int, *, feed_plan, nulls_plan,
                          filter_nulls, match_cap: int,
                          out: Stores | None = None):
        """Fused probe + insert + inner scatter, nothing fetched; returns
        (mine', inner_state (updated in place), per-shard totals).
        `inner` is the query's ShardedLattice on the same mesh."""
        new, totals = sharded_join_probe_insert_step(
            mine, other, batch, n, within, cutoff, match_cap,
            self.n_cols[side],
            inner.local_spec, inner_state, wm_rel, ts_off, inner._progs,
            (feed_plan, nulls_plan, filter_nulls), outs=out)
        return new, inner_state, totals

    def evict(self, left: Stores, right: Stores, cutoff: int, delta: int,
              out: tuple[Stores, Stores] | None = None):
        return sharded_join_evict(left, right, cutoff, delta, outs=out)

    def unpack_matches(self, packed: np.ndarray, side: str):
        """Flatten the shard-concatenated match buffer into host arrays in
        shard order: (total, kid, jts_rel, my_flags, other_flags, my_cols,
        other_cols), the sharded twin of join_lattice.unpack_join_matches;
        `total` sums the per-shard headers."""
        nm = self.n_cols[side]
        match_cap = packed.shape[1] // self.n_shards
        parts = []
        total = 0
        for s in range(self.n_shards):
            seg = packed[:, s * match_cap:(s + 1) * match_cap]
            t, kid, jts, mf, of, mc, oc = jl.unpack_join_matches(seg, nm)
            total += t
            parts.append((kid, jts, mf, of, mc, oc))
        return (total,
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts]),
                np.concatenate([p[4] for p in parts], axis=1),
                np.concatenate([p[5] for p in parts], axis=1))
