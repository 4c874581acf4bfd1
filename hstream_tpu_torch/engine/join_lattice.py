"""The interval join's device stores and programs (the port of the join
half of hstream_tpu/engine/lattice.py, :868-1173).

Each side of the join is a STORE of `cap` entries sorted by (code, ts):
key code, ts (int32 ms relative to the join's epoch), a flags word (2
bits per stored column: bit 2j = SQL NULL, bit 2j+1 = present) and the
stored columns cols [n_cols, cap] (f32 bits / int32 / bool / dictionary
id). Empty and evicted slots hold the sentinel code 2^22 with ts 0, so
they sort last. A micro-batch arrives as one int32 buffer [4 + n_cols,
bcap] (rows: code, ts, inner key id, flags, cols), sorted by (code, ts)
on the host and padded with (sentinel, 0).

Match buffer (int32 [5 + n_cols_mine + n_cols_other, match_cap]): row 0
zero but [0] = the true match total (it may exceed match_cap), row 1 the
inner key id, row 2 the joined ts (max of the pair), rows 3/4 the
probing and the stored side's flags, then both sides' columns.

Each program is a hand-written Hopper kernel (engine/kernels/csrc),
reached through a wrapper that launches it when its tensors lie on the
card and counts the launch in `.launches`, and runs the plain PyTorch
version in this module only when they lie on the CPU:

  join_probe_insert      <- join_probe_insert  (csrc/join_probe.cu pack
                                                mode, csrc/join_insert.cu)
  join_probe_only        <- join_probe_only    (join_probe.cu pack mode)
  join_probe_insert_step <- join_probe_insert_step (join_probe.cu feed
                            mode, then the window step's own kernels,
                            lattice.step_decoded, then join_insert.cu)
  join_evict             <- join_evict         (csrc/join_evict.cu)

and session_lattice.session_remap with `sent_above` for the code remap.
The plain versions follow the reference's operations: one stable sort
of a composite key where it sorts (_join_bounds, _join_insert,
join_evict). The kernels rely on the store and the batch being sorted
and sort nothing: the probe searches a store window per tile of sorted
records and expands the matches by a load-balancing search, the insert
is a merge path, the eviction a one-launch stable compaction (join_core.cuh,
join_insert.cu, join_evict.cu; `branch` forces the probe's store
search). The tests
hold numpy models of those plans, and `insert_merge_ref` and
`evict_compact_ref` (the merge and the compaction in plain PyTorch),
against the sorts.

Where the reference builds new stores functionally, the card's wrappers
write into an `out` store the caller passes (the executor ping-pongs
two per side); the plain versions return new tensors.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Sequence

import numpy as np
import torch

from hstream_tpu_torch.engine import lattice
from hstream_tpu_torch.engine.kernels import binding as kb

JOIN_SENT_CODE = 1 << 22   # code sentinel: empty/evicted slots (> any
                           # live code; the executor compacts at 2^22)
JOIN_MAX_COLS = 14         # 2 bits (null, present) per column in one
                           # int32 flags word

Store = dict[str, torch.Tensor]


def init_join_store(cap: int, n_cols: int,
                    device: str | torch.device = "cpu") -> Store:
    """One empty join side: all slots carry the code sentinel."""
    return {
        "code": torch.full((cap,), JOIN_SENT_CODE, dtype=torch.int32,
                           device=device),
        "ts": torch.zeros(cap, dtype=torch.int32, device=device),
        "flags": torch.zeros(cap, dtype=torch.int32, device=device),
        "cols": torch.zeros((n_cols, cap), dtype=torch.int32, device=device),
    }


def empty_join_store(cap: int, n_cols: int,
                     device: str | torch.device) -> Store:
    """Uninitialized store planes, for a kernel to write."""
    return {k: torch.empty(shape, dtype=torch.int32, device=device)
            for k, shape in (("code", (cap,)), ("ts", (cap,)),
                             ("flags", (cap,)), ("cols", (n_cols, cap)))}


def unpack_join_matches(packed: np.ndarray, n_cols_mine: int):
    """(total, kid, jts_rel, my_flags, other_flags, my_cols, other_cols)
    from a fetched match buffer; arrays sliced to the in-buffer match
    count (total may exceed it; the caller re-probes wider)."""
    total = int(packed[0, 0])
    m = min(total, packed.shape[1])
    return (total, packed[1, :m], packed[2, :m], packed[3, :m],
            packed[4, :m], packed[5:5 + n_cols_mine, :m],
            packed[5 + n_cols_mine:, :m])


# ---- the plain programs (lattice.py:884-1162) -------------------------------

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's complement wrap (jnp's int32 arithmetic)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _key2(code: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (code, ts) for int32 code and ts."""
    return code.to(torch.int64) * (1 << 32) + (ts.to(torch.int64) + (1 << 31))


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _join_bounds(store_code, store_ts, qcode, lo_ts, hi_ts):
    """[lower, upper) bounds of each query's (code, ts) span in a store
    sorted by (code, ts), as the reference computes them: ONE stable
    3-key sort ranks both query sets among the store entries (tag 0
    sorts lo-queries before equal store keys, tag 2 hi-queries after
    them); a query at position p with k queries before it has p - k
    store entries before it. Codes lie in [0, 2^29)."""
    cap = store_code.shape[0]
    bcap = qcode.shape[0]
    dev = store_code.device
    codes = torch.cat([store_code, qcode, qcode]).to(torch.int64)
    tss = torch.cat([store_ts, lo_ts, hi_ts]).to(torch.int64) + (1 << 31)
    tags = torch.cat([torch.ones(cap, dtype=torch.int64, device=dev),
                      torch.zeros(bcap, dtype=torch.int64, device=dev),
                      torch.full((bcap,), 2, dtype=torch.int64, device=dev)])
    pay = torch.cat([torch.full((cap,), 2 * bcap, dtype=torch.int64,
                                device=dev),
                     torch.arange(2 * bcap, dtype=torch.int64, device=dev)])
    spay = pay[_stable_order((codes << 34) | (tss << 2) | tags)]
    pos = torch.arange(cap + 2 * bcap, dtype=torch.int64, device=dev)
    is_q = spay < 2 * bcap
    k = torch.cumsum(is_q.to(torch.int64), 0) - 1
    bounds = torch.zeros(2 * bcap, dtype=torch.int32, device=dev)
    bounds[spay[is_q]] = (pos - k)[is_q].to(torch.int32)
    return bounds[:bcap], bounds[bcap:]


def _batch_valid(batch: torch.Tensor, n: int) -> torch.Tensor:
    bcap = batch.shape[1]
    return ((torch.arange(bcap, device=batch.device) < n)
            & (batch[0] < JOIN_SENT_CODE))


def owned_mask(codes: torch.Tensor, shard: tuple[int, int]) -> torch.Tensor:
    """Which codes a key shard of a mesh owns: code mod n_shards == shard,
    the floor modulo of the reference's jnp % (parallel/lattice.py:394)."""
    n_shards, s = shard
    return torch.remainder(codes, n_shards) == s


def owned_batch(batch: torch.Tensor, n: int, shard: tuple[int, int]
                ) -> tuple[torch.Tensor, int]:
    """The batch's valid records that a key shard owns, in order, and
    their count: the run the insert kernel merges for a key shard
    (csrc/join_insert.cu). Unowned records are left out, where the
    reference keeps them as dead (sentinel, ts) entries that the store's
    first `cap` places take only for a ts below the store sentinels' 0;
    the executor's rebase keeps every batch ts >= 0."""
    keep = _batch_valid(batch, n) & owned_mask(batch[0], shard)
    sub = batch[:, keep].contiguous()
    return sub, sub.shape[1]


def _join_match_arrays(other: Store, batch: torch.Tensor, n: int,
                       within: int, cutoff: int, match_cap: int,
                       owned: torch.Tensor | None = None,
                       records: torch.Tensor | None = None):
    """The probe core: expand the per-record [lower, upper) spans into
    padded match index arrays. Returns (total, rec, oidx, mvalid, jts):
    rec indexes the batch, oidx the probed store. `owned` (bool [bcap] or
    None) masks the records a key shard of a mesh probes; `records` (the
    batch indices of valid records, in order) probes only those, as a
    table launch reads a shard's group of its grouping (group_ref).
    Past the matches rec is the batch's last record either way."""
    cap = other["code"].shape[0]
    bcap = batch.shape[1]
    dev = batch.device
    if records is not None:
        records = records.long()
        bcode, bts = batch[0][records], batch[1][records]
        bvalid = torch.ones_like(records, dtype=torch.bool)
    else:
        bcode, bts = batch[0], batch[1]
        bvalid = _batch_valid(batch, n)
        if owned is not None:
            bvalid = bvalid & owned
    j = torch.arange(match_cap, dtype=torch.int32, device=dev)
    if bcode.shape[0] == 0:   # an empty group
        zero = torch.zeros(match_cap, dtype=torch.long, device=dev)
        return 0, zero + (bcap - 1), zero, j < 0, zero.to(torch.int32)
    qcode = torch.where(bvalid, bcode, JOIN_SENT_CODE)
    b64 = bts.to(torch.int64)
    lo_i, hi_i = _join_bounds(
        other["code"], other["ts"], qcode,
        torch.clamp(_wrap32(b64 - within), min=cutoff),
        _wrap32(b64 + within))
    cnt = torch.where(bvalid, torch.clamp(hi_i - lo_i, min=0), 0)
    ccnt = torch.cumsum(cnt, 0, dtype=torch.int32)
    total = int(ccnt[-1])
    r = torch.clamp(torch.searchsorted(ccnt, j, right=True), 0,
                    bcode.shape[0] - 1)
    mvalid = j < min(total, match_cap)
    oidx = lo_i[r] + (j - (ccnt[r] - cnt[r]))
    oidx = torch.where(mvalid, torch.clamp(oidx, 0, cap - 1), 0).long()
    rec = r if records is None else torch.where(mvalid, records[r], bcap - 1)
    jts = torch.where(mvalid, torch.maximum(batch[1][rec],
                                            other["ts"][oidx]), 0)
    return total, rec, oidx, mvalid, jts


def join_probe_ref(other: Store, batch: torch.Tensor, n: int, within: int,
                   cutoff: int, match_cap: int, n_cols_mine: int,
                   owned: torch.Tensor | None = None,
                   records: torch.Tensor | None = None) -> torch.Tensor:
    """Plain probe (_join_probe, lattice.py:939-959): the packed match
    buffer. `cutoff` hides store entries past retention (the device
    store evicts lazily); `owned` and `records` as in
    _join_match_arrays."""
    total, rec, oidx, mvalid, jts = _join_match_arrays(
        other, batch, n, within, cutoff, match_cap, owned, records)
    zero = torch.zeros((), dtype=torch.int32, device=batch.device)
    header = torch.zeros(match_cap, dtype=torch.int32, device=batch.device)
    header[0] = total
    rows = [header,
            torch.where(mvalid, batch[2][rec], zero),
            jts.to(torch.int32),
            torch.where(mvalid, batch[3][rec], zero),
            torch.where(mvalid, other["flags"][oidx], zero)]
    mcols = torch.where(mvalid[None, :], batch[4:4 + n_cols_mine][:, rec],
                        zero)
    ocols = torch.where(mvalid[None, :], other["cols"][:, oidx], zero)
    return torch.cat([torch.stack(rows), mcols, ocols], dim=0)


def join_insert_ref(mine: Store, batch: torch.Tensor, n: int,
                    n_cols: int) -> Store:
    """Plain insert (_join_insert, lattice.py:962-981): one stable
    2-key sort of store ++ batch (padding keyed as the sentinel), the
    first `cap` entries kept."""
    cap = mine["code"].shape[0]
    code = torch.cat([mine["code"],
                      torch.where(_batch_valid(batch, n), batch[0],
                                  JOIN_SENT_CODE)])
    ts = torch.cat([mine["ts"], batch[1]])
    order = _stable_order(_key2(code, ts))[:cap]
    return {"code": code[order], "ts": ts[order],
            "flags": torch.cat([mine["flags"], batch[3]])[order],
            "cols": torch.cat([mine["cols"], batch[4:4 + n_cols]],
                              dim=1)[:, order]}


def insert_merge_ref(mine: Store, batch: torch.Tensor, n: int,
                     n_cols: int) -> Store:
    """The insert as csrc/join_insert.cu computes it, in plain PyTorch: a
    merge of the two sorted runs. Store entry i goes to i + #(batch keys
    < its key), batch entry j to j + #(store keys <= its key); the first
    `cap` places are kept. Equal to join_insert_ref when both runs are
    sorted (tests/test_torch_join_lattice.py)."""
    cap = mine["code"].shape[0]
    bcap = batch.shape[1]
    dev = batch.device
    bcode = torch.where(_batch_valid(batch, n), batch[0], JOIN_SENT_CODE)
    skey = _key2(mine["code"], mine["ts"])
    bkey = _key2(bcode, batch[1])
    spos = torch.arange(cap, device=dev) + torch.searchsorted(bkey, skey)
    bpos = torch.arange(bcap, device=dev) + torch.searchsorted(
        skey, bkey, right=True)
    out = {"code": torch.empty(cap + bcap, dtype=torch.int32, device=dev),
           "ts": torch.empty(cap + bcap, dtype=torch.int32, device=dev),
           "flags": torch.empty(cap + bcap, dtype=torch.int32, device=dev),
           "cols": torch.empty((n_cols, cap + bcap), dtype=torch.int32,
                               device=dev)}
    for pos, (c, t, f, cv) in ((spos, (mine["code"], mine["ts"],
                                       mine["flags"], mine["cols"])),
                               (bpos, (bcode, batch[1], batch[3],
                                       batch[4:4 + n_cols]))):
        out["code"][pos] = c
        out["ts"][pos] = t
        out["flags"][pos] = f
        out["cols"][:, pos] = cv
    return {k: (v[..., :cap]).contiguous() for k, v in out.items()}


def join_probe_insert_ref(mine: Store, other: Store, batch: torch.Tensor,
                          n: int, within: int, cutoff: int, match_cap: int,
                          n_cols_mine: int):
    """Plain join_probe_insert (lattice.py:984-998): (mine', packed)."""
    packed = join_probe_ref(other, batch, n, within, cutoff, match_cap,
                            n_cols_mine)
    return join_insert_ref(mine, batch, n, n_cols_mine), packed


def _join_match_feed(other: Store, batch: torch.Tensor, n: int,
                     within: int, cutoff: int, match_cap: int,
                     feed_plan, nulls_plan, filter_nulls,
                     owned: torch.Tensor | None = None,
                     records: torch.Tensor | None = None):
    """Probe + inner feed (_join_match_feed, lattice.py:1016-1079): every
    inner-step column resolved straight from the match sources. Returns
    (total, kid, jts, valid, cols); `cols` holds the __null_a{i} masks,
    `valid` has filter-NULL records masked out; `owned` and `records` as
    in _join_match_arrays."""
    total, rec, oidx, mvalid, jts = _join_match_arrays(
        other, batch, n, within, cutoff, match_cap, owned, records)
    mflags = batch[3][rec]
    oflags = other["flags"][oidx]
    zero = torch.zeros(match_cap, dtype=torch.int32, device=batch.device)

    def bit(flags, b):
        return ((flags >> b) & 1) != 0

    def lpres_of(src, jm, jo):
        # which physical side is the SQL left side: "both" = the probing
        # batch, "both_o" = the probed store
        return bit(mflags, 2 * jm + 1) if src == "both" \
            else bit(oflags, 2 * jo + 1)

    def null_bit(src, jm, jo):
        mnull = bit(mflags, 2 * jm) if jm >= 0 else None
        onull = bit(oflags, 2 * jo) if jo >= 0 else None
        if src == "m":
            return mnull
        if src == "o":
            return onull
        left, right = (mnull, onull) if src == "both" else (onull, mnull)
        return torch.where(lpres_of(src, jm, jo), left, right)

    def raw_val(src, jm, jo):
        mv = batch[4 + jm][rec] if jm >= 0 else zero
        ov = other["cols"][jo][oidx] if jo >= 0 else zero
        if src == "m":
            return mv
        if src == "o":
            return ov
        left, right = (mv, ov) if src == "both" else (ov, mv)
        return torch.where(lpres_of(src, jm, jo), left, right)

    cols: dict[str, torch.Tensor] = {}
    for name, tag, src, jm, jo in feed_plan:
        raw = raw_val(src, jm, jo).contiguous()
        if tag == "f32":
            cols[name] = raw.view(torch.float32)
        elif tag == "bool":
            cols[name] = raw != 0
        else:
            cols[name] = raw
    for null_key, refs in nulls_plan:
        m = torch.zeros(match_cap, dtype=torch.bool, device=batch.device)
        for src, jm, jo in refs:
            m = m | null_bit(src, jm, jo)
        cols[null_key] = m
    valid = mvalid
    for src, jm, jo in filter_nulls:
        valid = valid & ~null_bit(src, jm, jo)
    kid = torch.where(mvalid, batch[2][rec], 0).to(torch.int32)
    return total, kid, jts.to(torch.int32), valid, cols


def join_probe_insert_step_ref(mine: Store, other: Store,
                               batch: torch.Tensor, n: int, within: int,
                               cutoff: int, match_cap: int,
                               n_cols_mine: int, spec, inner_state,
                               wm_rel: int, ts_off: int, progs, feed) -> tuple:
    """Plain join_probe_insert_step (lattice.py:1082-1128): the probe,
    the window step of every match into `inner_state` (in place: the
    plain expression programs, scatter and top-k fold, on any device),
    then the insert. `feed` is (feed_plan, nulls_plan,
    filter_nulls). Returns (mine', total)."""
    feed_plan, nulls_plan, filter_nulls = feed
    total, kid, jts, valid, cols = _join_match_feed(
        other, batch, n, within, cutoff, match_cap, feed_plan, nulls_plan,
        filter_nulls)
    ts_inner = _wrap32(jts.to(torch.int64) + ts_off)
    for prog, name in progs:      # the plain expression programs
        r = prog(cols)
        if name is None:
            valid = valid & r
        else:
            cols[name] = r
    lattice.scatter_step_ref(spec, inner_state, int(wm_rel), kid, ts_inner,
                             valid, cols)
    lattice.topk_step_ref(spec, inner_state, int(wm_rel), kid, ts_inner,
                          valid, cols)
    return join_insert_ref(mine, batch, n, n_cols_mine), total


def _evict_keys(st: Store, cutoff: int, delta: int):
    code, ts = st["code"], st["ts"]
    alive = (code < JOIN_SENT_CODE) & (ts >= cutoff)
    code2 = torch.where(alive, code, JOIN_SENT_CODE)
    ts2 = torch.where(alive, _wrap32(ts.to(torch.int64) - delta), 0)
    return alive, code2, ts2


def join_evict_ref(left: Store, right: Store, cutoff: int, delta: int):
    """Plain join_evict (lattice.py:1131-1162), both sides: survivors
    (code < sentinel, ts >= cutoff) shifted by -delta, dead entries as
    (sentinel, 0), one stable 2-key sort reordering flags and cols.
    Returns (left', right', live counts int32 [2])."""
    out, ns = [], []
    for st in (left, right):
        alive, code2, ts2 = _evict_keys(st, cutoff, delta)
        order = _stable_order(_key2(code2, ts2))
        out.append({"code": code2[order], "ts": ts2[order],
                    "flags": st["flags"][order],
                    "cols": st["cols"][:, order]})
        ns.append(alive.sum())
    return out[0], out[1], torch.stack(ns).to(torch.int32)


def evict_compact_ref(left: Store, right: Store, cutoff: int, delta: int):
    """The eviction as csrc/join_evict.cu computes it, in plain PyTorch: a
    stable compaction (live entries first in their order, then the dead
    ones in theirs as (sentinel, 0)). Equal to join_evict_ref when each
    store is sorted by (code, ts) (tests/test_torch_join_lattice.py)."""
    out, ns = [], []
    for st in (left, right):
        alive, code2, ts2 = _evict_keys(st, cutoff, delta)
        a = alive.to(torch.int64)
        before = torch.cumsum(a, 0) - a
        n_live = int(a.sum())
        idx = torch.arange(a.shape[0], device=a.device)
        pos = torch.where(alive, before, n_live + idx - before)
        o = {k: torch.empty_like(v) for k, v in st.items()}
        o["code"][pos] = code2
        o["ts"][pos] = ts2
        o["flags"][pos] = st["flags"]
        o["cols"][:, pos] = st["cols"]
        out.append(o)
        ns.append(n_live)
    return out[0], out[1], torch.tensor(ns, dtype=torch.int32,
                                        device=left["code"].device)


def store_sorted(st: Mapping[str, torch.Tensor]) -> bool:
    """Whether a store's (code, ts) keys are non-decreasing (the
    invariant every program keeps and the kernels rely on)."""
    k = _key2(st["code"], st["ts"])
    return bool((k[1:] >= k[:-1]).all())


# ---- the kernels' wrappers --------------------------------------------------

def _check_store(st: Mapping[str, torch.Tensor], what: str) -> int:
    """A store's slot count; each plane a contiguous int32 CUDA tensor of
    matching width."""
    cap = st["code"].shape[0]
    for k in ("code", "ts", "flags", "cols"):
        v = st[k]
        want = (cap,) if k != "cols" else (v.shape[0], cap)
        if (v.dtype != torch.int32 or not v.is_cuda or not v.is_contiguous()
                or tuple(v.shape) != want
                or v.device != st["code"].device):
            raise ValueError(f"{what}: plane {k} is not a contiguous int32 "
                             f"{list(want)} tensor on the store's card")
    if st["cols"].shape[0] > JOIN_MAX_COLS:
        raise ValueError(f"{what}: more than {JOIN_MAX_COLS} columns")
    return cap


def _aliases(a: Store, b: Store) -> bool:
    """Whether a non-empty plane of `a` shares its memory with `b`'s."""
    return any(a[k].numel() and a[k].data_ptr() == b[k].data_ptr()
               for k in a)


def _check_batch(batch: torch.Tensor, n_cols: int, n: int) -> int:
    if (batch.dtype != torch.int32 or batch.dim() != 2 or not batch.is_cuda
            or not batch.is_contiguous() or batch.shape[0] != 4 + n_cols
            or batch.shape[1] < 1 or not 0 <= n <= batch.shape[1]):
        raise ValueError(f"join batch must be a contiguous int32 "
                         f"[{4 + n_cols}, bcap >= 1] CUDA tensor with "
                         f"n <= bcap")
    return batch.shape[1]


def _i32(v: int, what: str) -> int:
    v = int(v)
    if not -(1 << 31) <= v < (1 << 31):
        raise ValueError(f"{what} {v} is outside int32")
    return v


PROBE_BRANCHES = (kb.PROBE_AUTO, kb.PROBE_WINDOW, kb.PROBE_WHOLE)


def _probe_base(cap: int, n_cols_other: int, batch: torch.Tensor, n: int,
                within: int, cutoff: int, match_cap: int, n_cols_mine: int,
                mode: int, branch: int | None) -> kb.JoinProbeArgs:
    """The probe's arguments but its store and scratch."""
    _check_batch(batch, n_cols_mine, n)
    if match_cap < 1:
        raise ValueError("join probe: match_cap must be >= 1")
    a = kb.JoinProbeArgs()
    a.cap, a.bcap, a.n = cap, batch.shape[1], int(n)
    a.within, a.cutoff = _i32(within, "within"), _i32(cutoff, "cutoff")
    a.match_cap, a.mode = int(match_cap), mode
    a.branch = kb.PROBE_AUTO if branch is None else branch
    if a.branch not in PROBE_BRANCHES:
        raise ValueError(f"join probe: unknown branch {branch}")
    a.n_cols_mine, a.n_cols_other = n_cols_mine, n_cols_other
    a.batch = batch.data_ptr()
    return a


def _probe_args(other: Store, batch: torch.Tensor, n: int, within: int,
                cutoff: int, match_cap: int, n_cols_mine: int,
                mode: int, branch: int | None
                ) -> tuple[kb.JoinProbeArgs, torch.Tensor]:
    cap = _check_store(other, "join probe")
    if other["code"].device != batch.device:
        raise ValueError("join probe: batch and store on different cards")
    a = _probe_base(cap, other["cols"].shape[0], batch, n, within, cutoff,
                    match_cap, n_cols_mine, mode, branch)
    a.o_code, a.o_ts, a.o_flags = (kb.ptr(other[k])
                                   for k in ("code", "ts", "flags"))
    a.o_cols = other["cols"].data_ptr()
    scratch = torch.empty(
        kb.lib().hs_join_probe_scratch_bytes(a.bcap, int(match_cap)),
        dtype=torch.uint8, device=batch.device)
    a.scratch = scratch.data_ptr()
    return a, scratch


def probe_pack_cuda(other: Store, batch: torch.Tensor, n: int, within: int,
                    cutoff: int, match_cap: int, n_cols_mine: int,
                    branch: int | None) -> torch.Tensor:
    """The probe kernel's launch in pack mode: the match buffer."""
    a, _scratch = _probe_args(other, batch, n, within, cutoff, match_cap,
                              n_cols_mine, kb.JOIN_PACK, branch)
    rows = 5 + n_cols_mine + other["cols"].shape[0]
    packed = torch.empty((rows, match_cap), dtype=torch.int32,
                         device=batch.device)
    a.packed, a.pitch = packed.data_ptr(), match_cap
    kb.check(kb.lib().hs_join_probe(ctypes.byref(a), kb.stream_of(batch)),
             "join_probe")
    return packed


def _insert_base(cap: int, batch: torch.Tensor, n: int,
                 n_cols: int) -> kb.JoinInsertArgs:
    """The insert's arguments but its stores and scratch."""
    a = kb.JoinInsertArgs()
    a.cap, a.bcap, a.n, a.n_cols = cap, _check_batch(batch, n_cols, n), \
        int(n), n_cols
    a.batch = batch.data_ptr()
    return a


def _check_insert_pair(mine: Store, out: Store, n_cols: int) -> int:
    cap = _check_store(mine, "join insert")
    if _check_store(out, "join insert output") != cap or \
            out["cols"].shape[0] != mine["cols"].shape[0] or \
            mine["cols"].shape[0] != n_cols:
        raise ValueError("join insert: the output store differs in shape")
    if _aliases(out, mine):
        raise ValueError("join insert: the output store aliases the input")
    return cap


def insert_cuda(mine: Store, batch: torch.Tensor, n: int, n_cols: int,
                out: Store) -> Store:
    """The insert kernel's launch into `out`."""
    a = _insert_base(_check_insert_pair(mine, out, n_cols), batch, n, n_cols)
    a.code, a.ts, a.flags = (kb.ptr(mine[k]) for k in ("code", "ts", "flags"))
    a.cols = mine["cols"].data_ptr()
    a.out_code, a.out_ts, a.out_flags = (kb.ptr(out[k])
                                         for k in ("code", "ts", "flags"))
    a.out_cols = out["cols"].data_ptr()
    scratch = torch.empty(kb.lib().hs_join_insert_scratch_bytes(a.cap,
                                                                a.bcap),
                          dtype=torch.uint8, device=batch.device)
    a.scratch = scratch.data_ptr()
    kb.check(kb.lib().hs_join_insert(ctypes.byref(a), kb.stream_of(batch)),
             "join_insert")
    return out


def join_probe_insert(mine: Store, other: Store, batch: torch.Tensor, n: int,
                      within: int, cutoff: int, match_cap: int,
                      n_cols_mine: int, out: Store | None = None,
                      branch: int | None = None):
    """The match-fetch path's batch (join_probe_insert, lattice.py:984-
    998): probe `other`, insert into `mine`. Returns (mine', packed
    match buffer). On the card: the probe kernels in pack mode (`branch`
    forces their store search: kb.PROBE_*), then the merge-insert kernel
    writing `out` (mine' is `out`); on the CPU the plain version."""
    if batch.device.type == "cpu":
        return join_probe_insert_ref(mine, other, batch, n, within, cutoff,
                                     match_cap, n_cols_mine)
    if out is None:
        raise ValueError("join_probe_insert: the card needs an out store")
    packed = probe_pack_cuda(other, batch, n, within, cutoff, match_cap,
                              n_cols_mine, branch)
    new = insert_cuda(mine, batch, n, n_cols_mine, out)
    join_probe_insert.launches += 1
    return new, packed


join_probe_insert.launches = 0  # wrapper calls that launched the kernels


def join_probe_only(other: Store, batch: torch.Tensor, n: int, within: int,
                    cutoff: int, match_cap: int, n_cols_mine: int,
                    branch: int | None = None) -> torch.Tensor:
    """The overflow redo (join_probe_only, lattice.py:1001-1013): the
    packed match buffer without an insert. The probe kernel in pack mode
    on the card, join_probe_ref on the CPU."""
    if batch.device.type == "cpu":
        return join_probe_ref(other, batch, n, within, cutoff, match_cap,
                              n_cols_mine)
    packed = probe_pack_cuda(other, batch, n, within, cutoff, match_cap,
                              n_cols_mine, branch)
    join_probe_only.launches += 1
    return packed


join_probe_only.launches = 0  # wrapper calls that launched the kernel


def _ref_args(r, what: str) -> tuple[int, int, int]:
    src, jm, jo = r
    if src not in kb.JOIN_SRC or jm >= JOIN_MAX_COLS or jo >= JOIN_MAX_COLS \
            or (src in ("m", "both") and jm < 0) \
            or (src in ("o", "both_o") and jo < 0) \
            or (src.startswith("both") and min(jm, jo) < 0):
        raise ValueError(f"join feed: bad reference {r} in {what}")
    return kb.JOIN_SRC[src], int(jm), int(jo)


def _feed_tag(tag: str) -> torch.dtype:
    return {"f32": torch.float32, "bool": torch.bool, "i32": torch.int32}[tag]


def _feed_args(a: kb.JoinProbeArgs, feed, column) -> dict:
    """The feed mode's column plan in `a`, each column's output from
    column(name, dtype); returns the columns."""
    feed_plan, nulls_plan, filter_nulls = feed
    if len(feed_plan) > kb.JOIN_MAX_FEED or \
            len(nulls_plan) > kb.JOIN_MAX_NULLS:
        raise ValueError("join feed: too many columns or masks")
    cols: dict[str, torch.Tensor] = {}
    for f, (name, tag, src, jm, jo) in enumerate(feed_plan):
        t = column(name, _feed_tag(tag))
        fc = a.feed[f]
        fc.ref.src, fc.ref.jm, fc.ref.jo = _ref_args((src, jm, jo), name)
        fc.tag, fc.out = kb.JOIN_TAG[tag], t.data_ptr()
        cols[name] = t
    a.n_feed = len(feed_plan)
    refs: list[tuple[int, int, int]] = []
    for q, (key, rs) in enumerate(nulls_plan):
        t = column(key, torch.bool)
        nl = a.nulls[q]
        nl.first, nl.count, nl.out = len(refs), len(rs), t.data_ptr()
        refs.extend(_ref_args(r, key) for r in rs)
        cols[key] = t
    a.n_nulls = len(nulls_plan)
    a.filter_first, a.filter_count = len(refs), len(filter_nulls)
    refs.extend(_ref_args(r, "WHERE") for r in filter_nulls)
    if len(refs) > kb.JOIN_MAX_REFS:
        raise ValueError("join feed: too many column references")
    for i, (s, jm, jo) in enumerate(refs):
        a.refs[i].src, a.refs[i].jm, a.refs[i].jo = s, jm, jo
    return cols


def feed_cuda(other: Store, batch: torch.Tensor, n: int, within: int,
              cutoff: int, match_cap: int, n_cols_mine: int, ts_off: int,
              feed, branch: int | None) -> tuple:
    """The probe kernel in feed mode: (total, kid, ts, valid, cols) of
    width match_cap on the card, cols holding the feed columns and
    masks."""
    a, scratch = _probe_args(other, batch, n, within, cutoff, match_cap,
                             n_cols_mine, kb.JOIN_FEED, branch)
    dev = batch.device
    kid, ts, valid = (torch.empty(match_cap, dtype=t, device=dev)
                      for t in (torch.int32, torch.int32, torch.bool))
    a.ts_off = _i32(ts_off, "ts_off")
    a.kid, a.ts, a.valid = kid.data_ptr(), ts.data_ptr(), valid.data_ptr()
    cols = _feed_args(a, feed, lambda name, dtype: torch.empty(
        match_cap, dtype=dtype, device=dev))
    kb.check(kb.lib().hs_join_probe(ctypes.byref(a), kb.stream_of(batch)),
             "join_probe_feed")
    total = scratch.view(torch.int32)[-1]
    return total, kid, ts, valid, cols


def join_probe_insert_step(mine: Store, other: Store, batch: torch.Tensor,
                           n: int, within: int, cutoff: int, match_cap: int,
                           n_cols_mine: int, spec, inner_state, wm_rel: int,
                           ts_off: int, progs, feed,
                           out: Store | None = None,
                           branch: int | None = None):
    """The fused batch (join_probe_insert_step, lattice.py:1082-1128):
    probe `other`, step every match into the window state `inner_state`
    (in place) and insert the batch into `mine`, with nothing fetched.
    `progs` are the inner step's expression programs
    (lattice.step_programs), `feed` its (feed_plan, nulls_plan,
    filter_nulls). Returns (mine', total): on the card the probe kernel
    in feed mode, the window step's kernels (lattice.step_decoded) on
    its columns and the merge-insert kernel into `out`, one stream, total
    a device scalar; on the CPU the plain version. `branch` forces the
    probe's store search (kb.PROBE_*)."""
    if batch.device.type == "cpu":
        return join_probe_insert_step_ref(
            mine, other, batch, n, within, cutoff, match_cap, n_cols_mine,
            spec, inner_state, wm_rel, ts_off, progs, feed)
    if out is None:
        raise ValueError("join_probe_insert_step: the card needs an out "
                         "store")
    total, kid, ts, valid, cols = feed_cuda(
        other, batch, n, within, cutoff, match_cap, n_cols_mine, ts_off,
        feed, branch)
    lattice.step_decoded(spec, inner_state, int(wm_rel), kid, ts, valid,
                         cols, progs)
    new = insert_cuda(mine, batch, n, n_cols_mine, out)
    join_probe_insert_step.launches += 1
    return new, total


join_probe_insert_step.launches = 0  # wrapper calls that launched them


def join_evict(left: Store, right: Store, cutoff: int, delta: int,
               out: Sequence[Store] | None = None):
    """Eviction + epoch rebase of both sides (join_evict, lattice.py:
    1131-1162). Returns (left', right', live counts int32 [2] on the
    stores' device, not fetched). The eviction kernel into the `out`
    pair on the card, join_evict_ref on the CPU."""
    if left["code"].device.type == "cpu":
        return join_evict_ref(left, right, cutoff, delta)
    if out is None:
        raise ValueError("join_evict: the card needs an out pair")
    n_out = evict_cuda(left, right, cutoff, delta, out)
    join_evict.launches += 1
    return out[0], out[1], n_out


def evict_cuda(left: Store, right: Store, cutoff: int, delta: int,
               out: Sequence[Store],
               n_out: torch.Tensor | None = None) -> torch.Tensor:
    """The eviction kernel's launch into the `out` pair; returns the live
    counts int32 [2] on the stores' device (written into `n_out`, a
    contiguous [2] tensor there, where given)."""
    cap = _check_store(left, "join evict")
    a = kb.JoinEvictArgs()
    a.cap = cap
    a.cutoff, a.delta = _i32(cutoff, "cutoff"), _i32(delta, "delta")
    for s, (st, o) in enumerate(zip((left, right), out)):
        if _check_store(st, "join evict") != cap or \
                _check_store(o, "join evict output") != cap or \
                o["cols"].shape[0] != st["cols"].shape[0]:
            raise ValueError("join evict: stores differ in shape")
        if _aliases(o, st):
            raise ValueError("join evict: an output store aliases its input")
        side = a.s[s]
        side.n_cols = st["cols"].shape[0]
        side.code, side.ts, side.flags = (kb.ptr(st[k])
                                          for k in ("code", "ts", "flags"))
        side.cols = st["cols"].data_ptr()
        side.out_code, side.out_ts, side.out_flags = (
            kb.ptr(o[k]) for k in ("code", "ts", "flags"))
        side.out_cols = o["cols"].data_ptr()
    dev = left["code"].device
    if n_out is None:
        n_out = torch.empty(2, dtype=torch.int32, device=dev)
    elif (n_out.shape != (2,) or n_out.dtype != torch.int32
          or not n_out.is_contiguous() or n_out.device != dev):
        raise ValueError("join evict: n_out is not a contiguous int32 [2] "
                         "tensor on the stores' card")
    scratch = torch.empty(kb.lib().hs_join_evict_scratch_bytes(cap),
                          dtype=torch.uint8, device=dev)
    a.n_out, a.scratch = n_out.data_ptr(), scratch.data_ptr()
    kb.check(kb.lib().hs_join_evict(ctypes.byref(a), kb.stream_of(n_out)),
             "join_evict")
    return n_out


join_evict.launches = 0  # wrapper calls that launched the kernels


# ---- the key-sharded join's table launches ----------------------------------
#
# The key shards of a mesh whose stores lie on one card probe and insert
# in one launch sequence over a table of their stores (csrc/join_group.cu,
# the table entries of join_probe.cu and join_insert.cu): the batch's
# valid records are grouped once by the table place of their owner (code
# mod n_shards), and the probe and the insert read each shard's records
# through that grouping. parallel/lattice.py plans the tables, a card
# each, and holds the plain versions.

JOIN_GROUP_TILE = kb.JOIN_GROUP_TILE


def group_ref(batch: torch.Tensor, n: int, shards: Sequence[int],
              n_shards: int) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The grouping csrc/join_group.cu writes, in plain PyTorch: (idx
    int64 [bcap + G * JOIN_GROUP_TILE], place -> batch index, -1 on the
    places past a group's records; base int64 [G + 1], each group's
    first place, a multiple of JOIN_GROUP_TILE, then the end; count int64
    [G]). Group g holds the valid records that shard shards[g] owns, in
    batch order; the records of shards outside the table are dropped."""
    bcap, G = batch.shape[1], len(shards)
    dev = batch.device
    valid = _batch_valid(batch, n)
    owner = torch.remainder(batch[0].to(torch.int64), n_shards)
    idx = torch.full((bcap + G * JOIN_GROUP_TILE,), -1, dtype=torch.int64,
                     device=dev)
    base = torch.zeros(G + 1, dtype=torch.int64)
    count = torch.zeros(G, dtype=torch.int64)
    at = 0
    for g, s in enumerate(shards):
        rec = torch.nonzero(valid & (owner == s)).flatten()
        base[g], count[g] = at, rec.shape[0]
        idx[at:at + rec.shape[0]] = rec
        at += -(-rec.shape[0] // JOIN_GROUP_TILE) * JOIN_GROUP_TILE
    base[G] = at
    return idx, base, count


def group_records(grouping, g: int) -> torch.Tensor:
    """Group g's batch indices from group_ref's grouping."""
    idx, base, count = grouping
    return idx[int(base[g]):int(base[g]) + int(count[g])]


def group_cuda(batch: torch.Tensor, n: int, shards: Sequence[int],
               n_shards: int) -> torch.Tensor:
    """The grouping kernel's launch for one table: the int32 grouping
    buffer on the batch's card, which probe_table_cuda and
    insert_table_cuda read."""
    _check_batch(batch, batch.shape[0] - 4, n)
    if not 1 <= len(shards) <= kb.JOIN_GROUP or \
            n_shards > kb.JOIN_MAX_SHARDS:
        raise ValueError(f"join grouping: a table of {len(shards)} of "
                         f"{n_shards} shards does not fit a launch")
    a = kb.JoinGroupArgs()
    a.bcap, a.n, a.n_shards, a.n_group = batch.shape[1], int(n), n_shards, \
        len(shards)
    for s in range(kb.JOIN_MAX_SHARDS):
        a.pos[s] = -1
    for g, s in enumerate(shards):
        a.pos[s] = g
    grouping = torch.empty(
        kb.lib().hs_join_group_bytes(a.bcap, a.n_group) // 4,
        dtype=torch.int32, device=batch.device)
    a.batch, a.grouping = batch.data_ptr(), grouping.data_ptr()
    kb.check(kb.lib().hs_join_group(ctypes.byref(a), kb.stream_of(batch)),
             "join_group")
    group_cuda.launches += 1
    return grouping


group_cuda.launches = 0  # launches of the grouping kernel


def _table_args(stores: Sequence[Store], shards: Sequence[int],
                grouping: torch.Tensor, outs: Sequence[Store] | None = None,
                at: Sequence[int] | None = None,
                totals: torch.Tensor | None = None) -> kb.JoinTable:
    """A table launch's argument: shard shards[g]'s store (and out store)
    in place g, its first match column or feed entry at[g]."""
    if not 1 <= len(shards) <= kb.JOIN_GROUP:
        raise ValueError(f"a join table of {len(shards)} shards does not "
                         f"fit a launch ({kb.JOIN_GROUP} at most)")
    t = kb.JoinTable()
    t.n_group = len(shards)
    t.grouping = grouping.data_ptr()
    t.totals = None if totals is None else totals.data_ptr()
    for g, s in enumerate(shards):
        h, st = t.sh[g], stores[s]
        h.code, h.ts, h.flags = (kb.ptr(st[k]) for k in ("code", "ts",
                                                         "flags"))
        h.cols = st["cols"].data_ptr()
        if outs is not None:
            o = outs[s]
            h.out_code, h.out_ts, h.out_flags = (
                kb.ptr(o[k]) for k in ("code", "ts", "flags"))
            h.out_cols = o["cols"].data_ptr()
        if at is not None:
            h.at = int(at[g])
    return t


def _table_cap(stores: Sequence[Store], shards: Sequence[int],
               dev: torch.device, what: str) -> int:
    """The table's stores' common slot count, each on `dev`."""
    caps = {_check_store(stores[s], what) for s in shards}
    if len(caps) != 1 or any(stores[s]["code"].device != dev
                             for s in shards) or len(
            {stores[s]["cols"].shape[0] for s in shards}) != 1:
        raise ValueError(f"{what}: a table's stores differ in shape or card")
    return caps.pop()


def probe_table_cuda(others: Sequence[Store], shards: Sequence[int],
                     grouping: torch.Tensor, batch: torch.Tensor, n: int,
                     within: int, cutoff: int, match_cap: int,
                     n_cols_mine: int, branch: int | None,
                     at: Sequence[int], packed: torch.Tensor | None = None,
                     feed=None, dest: tuple | None = None,
                     totals: torch.Tensor | None = None) -> None:
    """The table probe's launches over the stores others[s] of `shards`
    (grouped by group_cuda): pack mode into `packed` (shard shards[g]'s
    match buffer at columns at[g] ...), or with `feed` = (plan, ts_off)
    feed mode into dest = (kid, ts, valid, cols) from entry at[g] on,
    each shard's total into totals[at[g] // match_cap]."""
    cap = _table_cap(others, shards, batch.device, "join probe table")
    n_other = others[shards[0]]["cols"].shape[0]
    if any(x % match_cap or x < 0 for x in at) or len(at) != len(shards):
        raise ValueError("join probe table: every shard's first column "
                         "must be a multiple of match_cap")
    a = _probe_base(cap, n_other, batch, n, within, cutoff, match_cap,
                    n_cols_mine, kb.JOIN_PACK if feed is None
                    else kb.JOIN_FEED, branch)
    width = max(at) + match_cap
    if feed is None:
        rows = 5 + n_cols_mine + n_other
        if packed.shape[0] != rows or packed.shape[1] < width or \
                not packed.is_contiguous() or packed.dtype != torch.int32:
            raise ValueError("join probe table: the match buffer differs "
                             "in shape")
        a.packed, a.pitch = packed.data_ptr(), packed.shape[1]
    else:
        plan, ts_off = feed
        kid, ts, valid, cols = dest
        if any(x.shape[0] < width for x in (kid, ts, valid)) or \
                any(v.shape[0] < width for v in cols.values()):
            raise ValueError("join probe table: the feed is too short")
        a.ts_off = _i32(ts_off, "ts_off")
        a.kid, a.ts, a.valid = kid.data_ptr(), ts.data_ptr(), \
            valid.data_ptr()
        _feed_args(a, plan, lambda name, dtype: cols[name])
    if totals is not None and totals.shape[0] < width // match_cap:
        raise ValueError("join probe table: the totals are too short")
    t = _table_args(others, shards, grouping, at=at, totals=totals)
    scratch = torch.empty(kb.lib().hs_join_probe_table_scratch_bytes(
        a.bcap, int(match_cap), t.n_group), dtype=torch.uint8,
        device=batch.device)
    a.scratch = scratch.data_ptr()
    kb.check(kb.lib().hs_join_probe_table(ctypes.byref(a), ctypes.byref(t),
                                          kb.stream_of(batch)),
             "join_probe_table")
    probe_table_cuda.launches += 1


probe_table_cuda.launches = 0  # launches of the table probe's kernels


def insert_table_cuda(mines: Sequence[Store], outs: Sequence[Store],
                      shards: Sequence[int], grouping: torch.Tensor,
                      batch: torch.Tensor, n: int, n_cols: int) -> None:
    """The table insert's launches: mines[s] merged with shard s's group
    of the grouping into outs[s], for every s in `shards`."""
    cap = _table_cap(mines, shards, batch.device, "join insert table")
    for s in shards:
        _check_insert_pair(mines[s], outs[s], n_cols)
    a = _insert_base(cap, batch, n, n_cols)
    t = _table_args(mines, shards, grouping, outs=outs)
    scratch = torch.empty(kb.lib().hs_join_insert_table_scratch_bytes(
        cap, t.n_group), dtype=torch.uint8, device=batch.device)
    a.scratch = scratch.data_ptr()
    kb.check(kb.lib().hs_join_insert_table(ctypes.byref(a), ctypes.byref(t),
                                           kb.stream_of(batch)),
             "join_insert_table")
    insert_table_cuda.launches += 1


insert_table_cuda.launches = 0  # launches of the table insert's kernels
