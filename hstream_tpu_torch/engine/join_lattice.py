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


def _join_match_arrays(other: Store, batch: torch.Tensor, n: int,
                       within: int, cutoff: int, match_cap: int):
    """The probe core: expand the per-record [lower, upper) spans into
    padded match index arrays. Returns (total, rec, oidx, mvalid, jts):
    rec indexes the batch, oidx the probed store."""
    cap = other["code"].shape[0]
    bcap = batch.shape[1]
    dev = batch.device
    bcode, bts = batch[0], batch[1]
    bvalid = _batch_valid(batch, n)
    qcode = torch.where(bvalid, bcode, JOIN_SENT_CODE)
    b64 = bts.to(torch.int64)
    lo_i, hi_i = _join_bounds(
        other["code"], other["ts"], qcode,
        torch.clamp(_wrap32(b64 - within), min=cutoff),
        _wrap32(b64 + within))
    cnt = torch.where(bvalid, torch.clamp(hi_i - lo_i, min=0), 0)
    ccnt = torch.cumsum(cnt, 0, dtype=torch.int32)
    total = int(ccnt[-1])
    j = torch.arange(match_cap, dtype=torch.int32, device=dev)
    rec = torch.clamp(torch.searchsorted(ccnt, j, right=True), 0,
                      bcap - 1)
    mvalid = j < min(total, match_cap)
    oidx = lo_i[rec] + (j - (ccnt[rec] - cnt[rec]))
    oidx = torch.where(mvalid, torch.clamp(oidx, 0, cap - 1), 0).long()
    jts = torch.where(mvalid, torch.maximum(bts[rec], other["ts"][oidx]), 0)
    return total, rec, oidx, mvalid, jts


def join_probe_ref(other: Store, batch: torch.Tensor, n: int, within: int,
                   cutoff: int, match_cap: int,
                   n_cols_mine: int) -> torch.Tensor:
    """Plain probe (_join_probe, lattice.py:939-959): the packed match
    buffer. `cutoff` hides store entries past retention (the device
    store evicts lazily)."""
    total, rec, oidx, mvalid, jts = _join_match_arrays(
        other, batch, n, within, cutoff, match_cap)
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
                     feed_plan, nulls_plan, filter_nulls):
    """Probe + inner feed (_join_match_feed, lattice.py:1016-1079): every
    inner-step column resolved straight from the match sources. Returns
    (total, kid, jts, valid, cols); `cols` holds the __null_a{i} masks,
    `valid` has filter-NULL records masked out."""
    total, rec, oidx, mvalid, jts = _join_match_arrays(
        other, batch, n, within, cutoff, match_cap)
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


def _probe_args(other: Store, batch: torch.Tensor, n: int, within: int,
                cutoff: int, match_cap: int, n_cols_mine: int,
                mode: int, branch: int | None
                ) -> tuple[kb.JoinProbeArgs, torch.Tensor]:
    cap = _check_store(other, "join probe")
    bcap = _check_batch(batch, n_cols_mine, n)
    if other["code"].device != batch.device:
        raise ValueError("join probe: batch and store on different cards")
    if match_cap < 1:
        raise ValueError("join probe: match_cap must be >= 1")
    a = kb.JoinProbeArgs()
    a.cap, a.bcap, a.n = cap, bcap, int(n)
    a.within, a.cutoff = _i32(within, "within"), _i32(cutoff, "cutoff")
    a.match_cap, a.mode = int(match_cap), mode
    a.branch = kb.PROBE_AUTO if branch is None else branch
    if a.branch not in PROBE_BRANCHES:
        raise ValueError(f"join probe: unknown branch {branch}")
    a.n_cols_mine, a.n_cols_other = n_cols_mine, other["cols"].shape[0]
    a.batch = batch.data_ptr()
    a.o_code, a.o_ts, a.o_flags = (kb.ptr(other[k])
                                   for k in ("code", "ts", "flags"))
    a.o_cols = other["cols"].data_ptr()
    scratch = torch.empty(
        kb.lib().hs_join_probe_scratch_bytes(bcap, int(match_cap)),
        dtype=torch.uint8, device=batch.device)
    a.scratch = scratch.data_ptr()
    return a, scratch


def _probe_pack_cuda(other: Store, batch: torch.Tensor, n: int, within: int,
                     cutoff: int, match_cap: int, n_cols_mine: int,
                     branch: int | None) -> torch.Tensor:
    a, _scratch = _probe_args(other, batch, n, within, cutoff, match_cap,
                              n_cols_mine, kb.JOIN_PACK, branch)
    packed = torch.empty((5 + n_cols_mine + other["cols"].shape[0],
                          match_cap), dtype=torch.int32, device=batch.device)
    a.packed = packed.data_ptr()
    kb.check(kb.lib().hs_join_probe(ctypes.byref(a), kb.stream_of(batch)),
             "join_probe")
    return packed


def _insert_cuda(mine: Store, batch: torch.Tensor, n: int, n_cols: int,
                 out: Store) -> Store:
    cap = _check_store(mine, "join insert")
    if _check_store(out, "join insert output") != cap or \
            out["cols"].shape[0] != mine["cols"].shape[0] or \
            mine["cols"].shape[0] != n_cols:
        raise ValueError("join insert: the output store differs in shape")
    if _aliases(out, mine):
        raise ValueError("join insert: the output store aliases the input")
    a = kb.JoinInsertArgs()
    a.cap, a.bcap, a.n, a.n_cols = cap, _check_batch(batch, n_cols, n), \
        int(n), n_cols
    a.code, a.ts, a.flags = (kb.ptr(mine[k]) for k in ("code", "ts", "flags"))
    a.cols = mine["cols"].data_ptr()
    a.batch = batch.data_ptr()
    a.out_code, a.out_ts, a.out_flags = (kb.ptr(out[k])
                                         for k in ("code", "ts", "flags"))
    a.out_cols = out["cols"].data_ptr()
    scratch = torch.empty(kb.lib().hs_join_insert_scratch_bytes(cap),
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
    packed = _probe_pack_cuda(other, batch, n, within, cutoff, match_cap,
                              n_cols_mine, branch)
    new = _insert_cuda(mine, batch, n, n_cols_mine, out)
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
    packed = _probe_pack_cuda(other, batch, n, within, cutoff, match_cap,
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


def _feed_cuda(other: Store, batch: torch.Tensor, n: int, within: int,
               cutoff: int, match_cap: int, n_cols_mine: int, ts_off: int,
               feed, branch: int | None) -> tuple:
    """The probe kernel in feed mode: (kid, ts, valid, cols) of width
    match_cap on the card, cols holding the feed columns and masks."""
    feed_plan, nulls_plan, filter_nulls = feed
    a, scratch = _probe_args(other, batch, n, within, cutoff, match_cap,
                             n_cols_mine, kb.JOIN_FEED, branch)
    dev = batch.device
    kid = torch.empty(match_cap, dtype=torch.int32, device=dev)
    ts = torch.empty(match_cap, dtype=torch.int32, device=dev)
    valid = torch.empty(match_cap, dtype=torch.bool, device=dev)
    a.ts_off = _i32(ts_off, "ts_off")
    a.kid, a.ts, a.valid = kid.data_ptr(), ts.data_ptr(), valid.data_ptr()
    if len(feed_plan) > kb.JOIN_MAX_FEED or \
            len(nulls_plan) > kb.JOIN_MAX_NULLS:
        raise ValueError("join feed: too many columns or masks")
    cols: dict[str, torch.Tensor] = {}
    for f, (name, tag, src, jm, jo) in enumerate(feed_plan):
        t = torch.empty(match_cap, device=dev, dtype={
            "f32": torch.float32, "bool": torch.bool,
            "i32": torch.int32}[tag])
        fc = a.feed[f]
        fc.ref.src, fc.ref.jm, fc.ref.jo = _ref_args((src, jm, jo), name)
        fc.tag, fc.out = kb.JOIN_TAG[tag], t.data_ptr()
        cols[name] = t
    a.n_feed = len(feed_plan)
    refs: list[tuple[int, int, int]] = []
    for q, (key, rs) in enumerate(nulls_plan):
        t = torch.empty(match_cap, dtype=torch.bool, device=dev)
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
    total, kid, ts, valid, cols = _feed_cuda(
        other, batch, n, within, cutoff, match_cap, n_cols_mine, ts_off,
        feed, branch)
    lattice.step_decoded(spec, inner_state, int(wm_rel), kid, ts, valid,
                         cols, progs)
    new = _insert_cuda(mine, batch, n, n_cols_mine, out)
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
    n_out = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(kb.lib().hs_join_evict_scratch_bytes(cap),
                          dtype=torch.uint8, device=dev)
    a.n_out, a.scratch = n_out.data_ptr(), scratch.data_ptr()
    kb.check(kb.lib().hs_join_evict(ctypes.byref(a), kb.stream_of(n_out)),
             "join_evict")
    join_evict.launches += 1
    return out[0], out[1], n_out


join_evict.launches = 0  # wrapper calls that launched the kernels
