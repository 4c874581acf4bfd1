"""Time a group of kernels of this checkout against the same kernels of
another checkout (the parent commit's, or any tree with chip_smoke.py),
on one CUDA card, in one call.

    python3 ab.py scatter|join|decode|expr|close|remap|unpack|session|sharded \
        OTHER_TREE

runs OTHER_TREE, this tree, this tree, OTHER_TREE, each in a process of
its own that builds its tree's kernels and times the group on the same
inputs, made from a seed at chip_smoke's path shapes. Prints the card's
name and power limit, then one line per run: `AB <tree> {name: ms, ...}`.

scatter: `lattice.scatter_step` on configs 1 and 2 and the changelog
query (2^20 records), CUDA events over 100 back-to-back calls after 10
warm-up calls, ms a call; a tree whose `scatter_step` takes `mode` runs
its global branch.

join: the changelog extract (B6) and the join's probe and merge-insert
(B17):
  * "touched changelog": lattice.extract_touched on the changelog query's
    lattice after one headline batch (1024 keys x 3 slots, all touched);
  * "touched join": the join's inner lattice (K = 2^19, W = 3, COUNT(*)),
    390,000 of its 1,572,864 cells touched, max_out K * W;
  * "probe feed": the probe in feed mode (join_lattice.feed_cuda) of a
    2^20-record batch over 512,000 keys against a 4,194,304-slot store
    holding 2,097,152 entries, WITHIN 1 s, match_cap 4,194,304 (in a tree
    whose probe takes a `branch`, also with each branch forced);
  * "insert": the merge of that batch into a store of the same shape;
  * "fused call": join_probe_insert_step (probe, the inner step, insert);
  * "probe only 8b", "probe insert 8b": join_probe_only and
    join_probe_insert (pack mode) at phase 8b's shapes: a 2^16-record
    batch over 32,000 keys against a 2^19-slot store of ~12 entries a
    key, every one within reach, match_cap 2^20 (both also by kernel,
    the probe with each branch forced);
  * "B19b sharded step", "B19b sharded probe insert", "B19b sharded
    probe only": the key-sharded join's fused step at 15b's shapes and
    its probe + insert and probe-only at 15c's (this checkout's
    chip_smoke.p15_join_inputs: two key shards on the card), each also
    by kernel, the step by stage.
Each is the device time a call from torch.profiler over 20 calls (the
tree's chip_smoke.kernel_ms: its kernels, memsets and copies, without
the host's gaps; the touched extract's refill of its flags timed alone
and taken out), then the same by CUDA events around the 20 calls
(", call"), which for a short kernel is the host's launch path; and the
fused call's device time by stage (the tree's _by_stage).

decode: the wire decode (B1a) and the top-k fold (B8), timed as the
join group's are (device ms and ", call"; " by kernel" splits a call's
device time by kernel):
  * "decode headline", "decode changelog": transport.decode_batch of
    the headline and changelog wires (2^20 records; the changelog's
    carries __valid and five __null_a{i} streams);
  * "decode delta 3x": a 3 x 2^20-record headline-like wire (keys,
    delta-packed ms timestamps, one-decimal temps);
  * "topk steady": lattice.topk_step on the changelog batch (WHERE
    applied) after one call, so the planes are full;
  * "topk fresh": the same on planes refilled to -inf before each call
    (the first batch of a window), the refill timed alone and taken out;
  * "ptxas": ptxas's registers, stack frame and spills of the decode,
    top-k and evict kernels, from the tree's build;
  * "write floor": PyTorch's fill of the headline decode's four output
    columns (2^20 records: 13 B each), the time of its writes alone.

expr: the expression kernel (B1b, B1b') and the join eviction (B18),
timed as the join group's are (device ms over 50 calls, ", call" and
" by kernel"):
  * "expr changelog": expr.eval_programs on the changelog query's WHERE
    and SUM input over its 2^20-record batch (chip_smoke.changelog_batch);
  * "expr unaries": phase 11's five programs (chip_smoke.log_programs:
    SQRT, ABS, LOG10, EXP, ROUND, CEIL) over a 2^20-record batch of its
    stream;
  * "evict": join_lattice.join_evict of two 2^21-slot stores without
    columns (the slots of phase 8's first eviction), each holding
    1,900,000 entries over 512,000 keys and 4 s of stream, the cutoff at
    1 s: a quarter of them dead, scattered among the live ones;
  * "evict half": the same stores holding 1,100,000 entries each and
    the cutoff at 0.2 s (~1,045,000 live, as phase 8's first eviction
    leaves), the dead ones mostly the empty tail;
  * "ptxas": ptxas's registers, stack frame and spills of expr.cu and
    join_evict.cu, from the tree's build.

close: the window close (close.cu: B2, B3, B5, B9), the session
extract (B13) and the changelog extract (B6, which shares finalize.cuh's
estimates), timed as the expr group's are, and two launches whose
argument blocks grew with the aggregate cap:
  * "B2 fused close", "B3 extract only": lattice.close_slots of one due
    slot of config 1's lattice (1024 keys, COUNT(*), SUM, HLL p = 10)
    after one headline batch, extract and reset / extract only;
  * "B9 extract_slot", "B9 reset_slot": the per-slot close of that slot;
  * "B5 reset-only close": lattice.reset_slots of one slot of the
    changelog query's lattice (2 KiB of quantile bins, two TOPK planes
    a cell);
  * "B6 touched changelog", "B6 touched join": lattice.extract_touched
    at the changelog's and the join's shapes (as the join group), the
    refill of the flags timed alone and taken out;
  * "B13 session extract": session_lattice.session_extract of config 4's
    spec (p50 and p99 on one 512-bin histogram) over an arena of 2^17
    slots, 6,250 slots named in ascending order (as the session
    executor's mirror names them) and padded to 8,192;
  * "scatter config 1": lattice.scatter_step of the headline batch (its
    planned branch), "session step": session_lattice.session_step of a
    2^16-record awkward batch into a 2^16-slot arena of every kind;
  * "ptxas": close.cu's, session_extract.cu's and touched.cu's
    registers, frames and spills.

remap: the code remap (B14) and the rebase (B4), timed as the expr
group's are (device ms over 100 calls, ", call" and " by kernel"):
  * "B14 session": session_lattice.session_remap of a 2^17-code plane
    (the session arena's) through a 2^16-entry table, a tenth of the
    codes the sentinel;
  * "B14 join 2^21", "B14 join 2^22": the join's code remap
    (sent_above) of a sorted store plane of 2^21 codes (the live
    entries a side) and of 2^22 (phase 8's store slots, half of them the
    sentinel) through a 2^20-entry table; back to back the plane and
    the table stay in L2, so each also " cold", after a 64 MiB write
    (the remap kernel's own time in " cold by kernel");
  * "B19c sharded remap": parallel.lattice.sharded_session_remap of
    15a's four code planes of 2^15 (this checkout's
    chip_smoke.p15_inputs) through a residue-preserving table of 2^17
    entries (one table launch; the earlier form launched once a shard);
  * "B4 rebase W=3", "B4 rebase W=8": lattice.rebase of config 1's and
    config 2's slot_start (3 and 8 slots, one empty);
  * "empty kernel": an empty kernel of the rebase's shape (one warp) on
    the same stream, the floor of any launch; a tree without one
    (before the rebase's redesign) reports None;
  * "ptxas": session_remap.cu's and rebase.cu's registers, frames and
    spills.

unpack: the packed batch's unpack (B10) and its sharded block form
(B19a-step), timed as the remap group's are (device ms over 100 calls,
", call" and " by kernel"):
  * "B10 unpack": lattice.unpack of config 1's headline batch
    (chip_smoke.headline_packed: [4, 2^20]), the single-card step's
    launch;
  * "B19a block unpack": parallel.lattice.unpack_block of data shard
    1's 2^19-record block of that batch with two key shards' columns, in
    a tree that has it (else None);
  * "ptxas": unpack.cu's registers, frames and spills.

session: the session step (B11) and merge (B12) at config 4's shapes,
timed as the remap group's are (device ms over 10 calls, ", call" and
" by kernel"):
  * "B11 session step": session_lattice.session_step of a 2^20-record
    batch (codes over 100,000 users, a second of times, |normal(50, 20)|
    latencies) into config 4's arena (p50 and p99 on one 512-bin
    histogram) of 2^17 slots, 40 % of them live (chip_smoke.random_arena
    with the rest made sentinels);
  * "B12 session merge": session_lattice.session_merge of 181,072
    segments (chip_smoke.session_seg: phase 7's segment count) into that
    arena;
  * "B19c sharded step", "B19c sharded merge": parallel.lattice's
    sharded_session_step and sharded_session_merge at phase 15a's shapes
    (this checkout's chip_smoke.p15_inputs, so both trees get the same
    inputs): four key shards of 2^15 slots on the card (make_mesh(1, 4)),
    each 40 % live with codes it owns, a 2^20-record batch over 100,000
    users, and 50,000 segments;
  * "ptxas": session_step.cu's and session_merge.cu's registers, frames
    and spills.

sharded: the merged close and changelog extract (B19a), the snapshot
merge (B19d) and the key-sharded session extract (B19c), timed as the
close group's are (device ms over 50 calls, ", call" and " by kernel"),
on this checkout's chip_smoke inputs so both trees time the same ones:
  * "B19a merged close", "B19a merged close extract only":
    parallel.lattice.close_merged of one due slot of config 1's lattice
    over SH_MESH's four partials (512 keys each: K = 1024, COUNT(*), SUM,
    HLL p = 10; chip_smoke.random_sharded_state), extract and reset /
    extract only;
  * "B19d snapshot merge": parallel.lattice.merge_partials of config 1's
    capture over the same four partials (its five planes), and "B19d
    snapshot merge 2x16" of config 1's lattice on make_mesh(2, 16) (64
    keys a key shard, 32 partials on the card; a tree that cannot merge
    it records its error);
  * "B19a merged touched push": parallel.lattice.touched_merged at the
    push query's shape (SH_MESH's four partials of 512 keys x 3 slots,
    one window's cells touched), the re-touch of the flags timed alone
    and taken out;
  * "B6 touched push": the single-card extract (lattice.extract_touched,
    its one launch) of the push query over 1024 keys x 3 slots, the same
    window's cells touched: the yardstick of the merged one launch;
  * "B19a merged touched 15b": the same at 15b's shape
    (chip_smoke.p15_touched_inputs: the join's inner lattice, K = 2^19 on
    the (2, 2) mesh, 390,000 cells touched), the refill of the flags
    timed alone and taken out;
  * "B19c sharded extract": parallel.lattice.sharded_session_extract at
    15a's inputs (chip_smoke.p15_inputs' four arenas of 2^15 slots, 6,250
    named slots in [4, 8192], p15_extract_slots);
  * "ptxas": close.cu's, shard_merge.cu's, touched.cu's and
    session_extract.cu's registers, frames and spills.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np

# the join group's phase-8 shapes
CAP = 1 << 22            # store slots a side
LIVE = 1 << 21           # live entries in the probed store
BATCH = 1 << 20
KEYS = 512_000
SPAN_MS = 4_000          # the stores' time range: ~2.1 M matches
WITHIN = 1000
INNER_KEYS = 1 << 19
TOUCHED = 390_000
# the close group's session extract: arena slots, named slots
SESS_CAP = 1 << 17
SESS_LIVE = 6_250
# the expr group's evictions: (entries a side, cutoff ms)
EVICT_CAP = 1 << 21
EVICTS = {"evict": (1_900_000, 1000), "evict half": (1_100_000, 200)}


def _scatter() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import expr as ex, lattice
    from hstream_tpu_torch.engine.kernels import build as kbuild

    kbuild.build()
    dev = torch.device("cuda", 0)
    kw = {}
    if "mode" in inspect.signature(lattice.scatter_step).parameters:
        from hstream_tpu_torch.engine.kernels import binding as kb
        kw = {"mode": kb.SCATTER_GLOBAL}

    def ms(fn, iters=100):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    out = {}
    _, _, _, (key, ts, valid, cols) = cs.headline_batch(dev, cs.make_spec(1))
    for cfg, tsv in ((1, ts), (2, ts + 100_000)):
        spec = cs.make_spec(cfg)
        st = lattice.init_state(spec, dev)
        out[f"config {cfg}"] = ms(lambda: lattice.scatter_step(
            spec, st, -1, key, tsv, valid, cols, **kw))
    cspec, progs, (key, ts, valid, cols), _ = cs.changelog_batch(dev)
    cols, valid = dict(cols), valid.clone()
    ex.eval_programs(progs, cols, valid)
    st = lattice.init_state(cspec, dev)
    out["changelog"] = ms(lambda: lattice.scatter_step(
        cspec, st, -1, key, ts, valid, cols, **kw))
    return out



def _inputs(seed: int = 8):
    """numpy inputs: the probed store, the probing side's store, the
    batch (rows code, ts, kid, flags), sorted by (code, ts)."""
    rng = np.random.default_rng(seed)

    def sorted_keys(n):
        c = rng.integers(0, KEYS, n).astype(np.int32)
        t = rng.integers(0, SPAN_MS, n).astype(np.int32)
        o = np.lexsort((t, c))
        return c[o], t[o]

    def store(n_live):
        code = np.full(CAP, 1 << 22, np.int32)
        ts = np.zeros(CAP, np.int32)
        code[:n_live], ts[:n_live] = sorted_keys(n_live)
        flags = np.full(CAP, 2, np.int32)
        return {"code": code, "ts": ts, "flags": flags,
                "cols": np.zeros((0, CAP), np.int32)}

    batch = np.zeros((4, BATCH), np.int32)
    batch[0], batch[1] = sorted_keys(BATCH)
    batch[2] = batch[0] % INNER_KEYS
    batch[3] = 2
    return store(LIVE), store(LIVE // 2), batch


def _join() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import join_lattice as jl
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import binding as kb
    from hstream_tpu_torch.engine.kernels import build as kbuild
    from hstream_tpu_torch.engine.plan import AggKind, AggSpec
    from hstream_tpu_torch.engine.window import TumblingWindow

    kbuild.build()
    dev = torch.device("cuda", 0)

    def ms(name, fn, less=None):
        dev_ms, call_ms, _src = cs.kernel_ms(fn, 20)
        if less is not None:
            dev_ms, call_ms = dev_ms - less[0], call_ms - less[1]
        out[name], out[name + ", call"] = dev_ms, call_ms

    def by_kernel(name, fn):   # device ms a call of each event
        d = cs.profiled_calls(fn, 5, name)
        out[name + " by kernel"] = (None if d is None else {
            k: v / 5e3 for k, v in d.items()})

    def touched_ms(name, spec, st, max_out):
        saved = st["touched"].clone()
        refill = cs.kernel_ms(lambda: st["touched"].copy_(saved), 20)
        ms(name, lambda: (st["touched"].copy_(saved),
                          lattice.extract_touched(spec, st, max_out)),
           refill[:2])
        by_kernel(name, lambda: (st["touched"].copy_(saved),
                                 lattice.extract_touched(spec, st, max_out)))

    out = {}
    cspec, progs, (key, ts, valid, cols), _ = cs.changelog_batch(dev)
    cst = lattice.init_state(cspec, dev)
    lattice.step_decoded(cspec, cst, -1, key, ts, valid.clone(), dict(cols),
                         progs)
    touched_ms("touched changelog", cspec, cst,
               lattice.touched_max_out(cspec, cs.BATCH))
    del cst

    ispec = lattice.LatticeSpec(
        n_keys=INNER_KEYS, window=TumblingWindow(10_000, grace_ms=0),
        aggs=(AggSpec(AggKind.COUNT_ALL, "c"),), track_touched=True)
    ist = lattice.init_state(ispec, dev)
    rng = np.random.default_rng(9)
    cells = ispec.n_keys * ispec.n_slots
    hit = torch.from_numpy(rng.choice(cells, TOUCHED, replace=False)).to(dev)
    ist["touched"].view(-1)[hit] = True
    ist["count"].view(-1)[hit] = torch.from_numpy(
        rng.integers(1, 9, TOUCHED).astype(np.int32)).to(dev)
    ist["slot_start"].copy_(torch.arange(3, device=dev,
                                         dtype=torch.int32) * 10_000)
    touched_ms("touched join", ispec, ist, cells)

    other, mine, batch = _inputs()
    other = {k: torch.from_numpy(v).to(dev) for k, v in other.items()}
    mine = {k: torch.from_numpy(v).to(dev) for k, v in mine.items()}
    batch = torch.from_numpy(batch).to(dev)
    feed = ((), (), ())
    # the launch helpers' names: feed_cuda / insert_cuda, or the older
    # _feed_cuda / _insert_cuda of a tree before the sharded join
    feed_cuda = getattr(jl, "feed_cuda", None) or jl._feed_cuda
    insert_cuda = getattr(jl, "insert_cuda", None) or jl._insert_cuda
    kw = ({"branch": None}
          if "branch" in inspect.signature(feed_cuda).parameters
          else {})
    def probe():
        feed_cuda(other, batch, BATCH, WITHIN, -(1 << 31), CAP, 0, 0,
                  feed, **kw)

    ms("probe feed", probe)
    by_kernel("probe feed", probe)
    if kw:   # a tree whose probe takes a branch: each one forced
        for bname in ("window", "whole"):
            kw["branch"] = getattr(kb, "PROBE_" + bname.upper())
            ms(f"probe feed, {bname}", probe)
        kw["branch"] = None
    dst = jl.empty_join_store(CAP, 0, dev)
    ms("insert", lambda: insert_cuda(mine, batch, BATCH, 0, dst))
    ist["touched"].zero_()

    def fused():   # COUNT(*): no programs
        jl.join_probe_insert_step(mine, other, batch, BATCH, WITHIN,
                                  -(1 << 31), CAP, 0, ispec, ist, -1, 0, (),
                                  feed, out=dst)

    ms("fused call", fused)
    stages = cs.profiled_calls(fused, 5, "the fused join")
    out["fused call by stage"] = (None if stages is None
                                  else cs._by_stage(stages, 5))
    total = feed_cuda(other, batch, BATCH, WITHIN, -(1 << 31), CAP, 0,
                      0, feed, **kw)[0]
    out["matches"] = int(total)

    # phase 8b's shapes: a 2^16-record batch over 32,000 keys, a 2^19-
    # slot store of ~12 entries a key, every entry of a key within reach
    rng = np.random.default_rng(10)

    def small_store(n_live):
        code = np.full(1 << 19, 1 << 22, np.int32)
        ts = np.zeros(1 << 19, np.int32)
        c = rng.integers(0, 32_000, n_live).astype(np.int32)
        t = rng.integers(0, 4_000, n_live).astype(np.int32)
        o = np.lexsort((t, c))
        code[:n_live], ts[:n_live] = c[o], t[o]
        return {"code": torch.from_numpy(code).to(dev),
                "ts": torch.from_numpy(ts).to(dev),
                "flags": torch.full((1 << 19,), 2, dtype=torch.int32,
                                    device=dev),
                "cols": torch.zeros((0, 1 << 19), dtype=torch.int32,
                                    device=dev)}

    s_other, s_mine = small_store(400_000), small_store(200_000)
    sb = np.zeros((4, 1 << 16), np.int32)
    c = rng.integers(0, 32_000, 1 << 16).astype(np.int32)
    t = rng.integers(0, 4_000, 1 << 16).astype(np.int32)
    o = np.lexsort((t, c))
    sb[0], sb[1], sb[2], sb[3] = c[o], t[o], c[o] % 1000, 2
    sbatch = torch.from_numpy(sb).to(dev)
    sdst = jl.empty_join_store(1 << 19, 0, dev)
    def probe_8b():
        jl.join_probe_only(s_other, sbatch, 1 << 16, 10_000, -(1 << 31),
                           1 << 20, 0, **kw)

    ms("probe only 8b", probe_8b)
    by_kernel("probe only 8b", probe_8b)
    if kw:
        for bname in ("window", "whole"):
            kw["branch"] = getattr(kb, "PROBE_" + bname.upper())
            ms(f"probe only 8b, {bname}", probe_8b)
        kw["branch"] = None
    def probe_insert_8b():
        jl.join_probe_insert(s_mine, s_other, sbatch, 1 << 16, 10_000,
                             -(1 << 31), 1 << 20, 0, out=sdst)

    ms("probe insert 8b", probe_insert_8b)
    by_kernel("probe insert 8b", probe_insert_8b)
    del s_other, s_mine, sbatch, sdst, other, mine, batch, dst, ist

    # B19b at 15b's and 15c's shapes: this checkout's
    # chip_smoke.p15_join_inputs, loaded by path, over the timed tree's
    # package (both trees time the same inputs)
    from hstream_tpu_torch.parallel import lattice as pl

    j = _here_chip_smoke().p15_join_inputs(dev)
    step = j["step"]
    outs = [jl.empty_join_store(x["code"].shape[0], x["cols"].shape[0],
                                dev) for x in step[0]]
    state = cs._clone(step[9])

    def sharded_step():
        pl.sharded_join_probe_insert_step(*step[:9], state, *step[10:],
                                          outs=outs)

    ms("B19b sharded step", sharded_step)
    by_kernel("B19b sharded step", sharded_step)
    stages = cs.profiled_calls(sharded_step, 5, "B19b sharded step")
    out["B19b sharded step by stage"] = (None if stages is None
                                         else cs._by_stage(stages, 5))
    del outs, state, step
    mines, others, batch, n, within, cutoff, mc, nm = j["probe"]
    outs = [jl.empty_join_store(x["code"].shape[0], x["cols"].shape[0],
                                dev) for x in mines]

    def sharded_probe_insert():
        pl.sharded_join_probe_insert(mines, others, batch, n, within,
                                     cutoff, mc, nm, outs=outs)

    ms("B19b sharded probe insert", sharded_probe_insert)
    by_kernel("B19b sharded probe insert", sharded_probe_insert)
    only = j["probe_only"]

    def sharded_probe_only():
        pl.sharded_join_probe_only(*only)

    ms("B19b sharded probe only", sharded_probe_only)
    by_kernel("B19b sharded probe only", sharded_probe_only)
    return out


def _here_chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (the timed tree's
    package underneath), so both trees time the same inputs."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke.py")
    mod = importlib.util.spec_from_file_location("chip_smoke_ab", path)
    here = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(here)
    return here


def _decode() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import expr as ex, lattice
    from hstream_tpu_torch.engine import transport as tp
    from hstream_tpu_torch.engine.kernels import build as kbuild

    built = kbuild.build()
    dev = torch.device("cuda", 0)
    out = {"ptxas": _ptxas(built.log, ("decode.cu", "topk.cu",
                                       "join_evict.cu"))}

    def ms(name, fn, less=None):
        dev_ms, call_ms, _src = cs.kernel_ms(fn, 20)
        if less is not None:
            dev_ms, call_ms = dev_ms - less[0], call_ms - less[1]
        out[name], out[name + ", call"] = dev_ms, call_ms
        d = cs.profiled_calls(fn, 5, name)
        out[name + " by kernel"] = (None if d is None else {
            k: v / 5e3 for k, v in d.items()})

    def fill():  # the headline decode's outputs, written by PyTorch
        for dt in (torch.int32, torch.int32, torch.float32, torch.bool):
            torch.empty(cs.BATCH, dtype=dt, device=dev).fill_(1)

    ms("write floor", fill)
    w, combo, bases, _ = cs.headline_batch(dev, cs.make_spec(1))
    ms("decode headline",
       lambda: tp.decode_batch(w, combo, cs.BATCH, cs.BATCH, bases))
    chg = cs.changelog_batch(dev)
    cw, ccombo, cbases = chg[3]
    ms("decode changelog",
       lambda: tp.decode_batch(cw, ccombo, cs.BATCH, cs.BATCH, cbases))
    big = 3 * cs.BATCH
    rng = np.random.default_rng(12)
    kids = rng.integers(0, cs.N_KEYS, big).astype(np.int32)
    ts = 10_000 + (np.arange(big, dtype=np.int64) * 600) // big
    temps = (np.rint(rng.normal(20, 5, big) * 10).astype(np.float32)
             * np.float32(0.1))
    bcombo, bbases, bwords = tp.BitpackTransport().encode(
        big, big, kids, ts, {"temp": temps}, (("temp", "f32"),))
    bw = torch.from_numpy(bwords.view(np.int32)).to(dev)
    out["delta 3x encodings"] = [(p.name, p.enc, p.bits) for p in bcombo]
    ms("decode delta 3x", lambda: tp.decode_batch(bw, bcombo, big, big,
                                                   bbases))
    del bw

    cspec, progs, (key, ts, valid, cols), _ = chg
    cols, valid = dict(cols), valid.clone()
    ex.eval_programs(progs, cols, valid)
    st = lattice.init_state(cspec, dev)
    lattice.topk_step(cspec, st, -1, key, ts, valid, cols)
    ms("topk steady",
       lambda: lattice.topk_step(cspec, st, -1, key, ts, valid, cols))
    planes = [k for k in st if k.endswith(("_topk", "_topk_distinct"))]
    fresh = {k: torch.full_like(st[k], float("-inf")) for k in planes}

    def refill():
        for k in planes:
            st[k].copy_(fresh[k])

    less = cs.kernel_ms(refill, 20)[:2]
    ms("topk fresh", lambda: (refill(), lattice.topk_step(
        cspec, st, -1, key, ts, valid, cols)), less)
    out["topk fresh refill"] = less[0]
    return out


def _expr() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import expr as ex
    from hstream_tpu_torch.engine import join_lattice as jl
    from hstream_tpu_torch.engine.kernels import build as kbuild

    built = kbuild.build()
    dev = torch.device("cuda", 0)
    out = {"ptxas": _ptxas(built.log, ("expr.cu", "join_evict.cu"))}

    def ms(name, fn):
        dev_ms, call_ms, _src = cs.kernel_ms(fn, 50)
        out[name], out[name + ", call"] = dev_ms, call_ms
        d = cs.profiled_calls(fn, 5, name)
        out[name + " by kernel"] = (None if d is None else {
            k: v / 5e3 for k, v in d.items()})

    _, progs, (_key, _ts, valid, cols), _ = cs.changelog_batch(dev)
    valid = valid.clone()
    ms("expr changelog", lambda: ex.eval_programs(progs, dict(cols), valid))
    lprogs = cs.log_programs()
    temp = torch.from_numpy(cs.Batches(cs.LOG_SEED).get(0)[2]).to(dev)
    lvalid = torch.ones(temp.shape[0], dtype=torch.bool, device=dev)
    ms("expr unaries", lambda: ex.eval_programs(lprogs, {"temp": temp},
                                                lvalid))

    rng = np.random.default_rng(13)

    def store(resident):
        code = np.full(EVICT_CAP, 1 << 22, np.int32)
        ts = np.zeros(EVICT_CAP, np.int32)
        c = rng.integers(0, KEYS, resident).astype(np.int32)
        t = rng.integers(0, SPAN_MS, resident).astype(np.int32)
        o = np.lexsort((t, c))
        code[:resident], ts[:resident] = c[o], t[o]
        flags = rng.integers(0, 1 << 28, EVICT_CAP).astype(np.int32)
        return {"code": torch.from_numpy(code).to(dev),
                "ts": torch.from_numpy(ts).to(dev),
                "flags": torch.from_numpy(flags).to(dev),
                "cols": torch.zeros((0, EVICT_CAP), dtype=torch.int32,
                                    device=dev)}

    outs = [jl.empty_join_store(EVICT_CAP, 0, dev) for _ in range(2)]
    for name, (resident, cutoff) in EVICTS.items():
        left, right = store(resident), store(resident)
        ms(name, lambda: jl.join_evict(left, right, cutoff, 0, out=outs))
        out[name + " live"] = jl.join_evict(left, right, cutoff, 0,
                                            out=outs)[2].tolist()
    return out


def _close() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.kernels import build as kbuild
    from hstream_tpu_torch.engine.plan import AggKind, AggSpec
    from hstream_tpu_torch.engine.window import TumblingWindow

    built = kbuild.build()
    dev = torch.device("cuda", 0)
    out = {"ptxas": _ptxas(built.log, ("close.cu", "session_extract.cu",
                                       "touched.cu"))}

    def ms(name, fn, less=None):
        dev_ms, call_ms, _src = cs.kernel_ms(fn, 50)
        if less is not None:
            dev_ms, call_ms = dev_ms - less[0], call_ms - less[1]
        out[name], out[name + ", call"] = dev_ms, call_ms
        d = cs.profiled_calls(fn, 5, name)
        out[name + " by kernel"] = (None if d is None else {
            k: v / 5e3 for k, v in d.items()})

    # B2, B3: config 1's lattice after one headline batch, one due slot
    spec = cs.make_spec(1)
    _, _, _, (key, ts, valid, cols) = cs.headline_batch(dev, spec)
    st = lattice.init_state(spec, dev)
    lattice.scatter_step(spec, st, -1, key, ts, valid, cols)
    slot = int(torch.nonzero(st["count"].sum(0))[0])
    one = lattice.pad_slots([slot])
    ms("B2 fused close", lambda: lattice.close_slots(spec, st, one))
    ms("B3 extract only", lambda: lattice.close_slots(
        spec, st, one, lattice.CLOSE_EXTRACT))
    ms("scatter config 1", lambda: lattice.scatter_step(
        spec, st, -1, key, ts, valid, cols))
    # B9: the same lattice, one slot
    st = lattice.init_state(spec, dev)
    lattice.scatter_step(spec, st, -1, key, ts, valid, cols)
    ms("B9 extract_slot", lambda: lattice.extract_slot(spec, st, slot))
    ms("B9 reset_slot", lambda: lattice.reset_slot(spec, st, slot))
    # B5 and B6 at the changelog's shape: its lattice after one batch
    cspec, progs, (key, ts, valid, cols), _ = cs.changelog_batch(dev)
    cst = lattice.init_state(cspec, dev)
    lattice.step_decoded(cspec, cst, -1, key, ts, valid.clone(), dict(cols),
                         progs)
    cslot = int(torch.nonzero(cst["count"].sum(0))[0])
    saved = cst["touched"].clone()
    refill = cs.kernel_ms(lambda: cst["touched"].copy_(saved), 20)[:2]
    mo = lattice.touched_max_out(cspec, cs.BATCH)
    ms("B6 touched changelog", lambda: (
        cst["touched"].copy_(saved),
        lattice.extract_touched(cspec, cst, mo)), refill)
    ms("B5 reset-only close", lambda: lattice.reset_slots(
        cspec, cst, lattice.pad_slots([cslot])))
    # B6 at the join's shape (K = 2^19, COUNT(*)), as the join group
    ispec = lattice.LatticeSpec(
        n_keys=INNER_KEYS, window=TumblingWindow(10_000, grace_ms=0),
        aggs=(AggSpec(AggKind.COUNT_ALL, "c"),), track_touched=True)
    ist = lattice.init_state(ispec, dev)
    rng = np.random.default_rng(9)
    cells = ispec.n_keys * ispec.n_slots
    hit = torch.from_numpy(rng.choice(cells, TOUCHED, replace=False)).to(dev)
    ist["touched"].view(-1)[hit] = True
    ist["count"].view(-1)[hit] = torch.from_numpy(
        rng.integers(1, 9, TOUCHED).astype(np.int32)).to(dev)
    ist["slot_start"].copy_(torch.arange(3, device=dev,
                                         dtype=torch.int32) * 10_000)
    saved_i = ist["touched"].clone()
    refill_i = cs.kernel_ms(lambda: ist["touched"].copy_(saved_i), 20)[:2]
    ms("B6 touched join", lambda: (
        ist["touched"].copy_(saved_i),
        lattice.extract_touched(ispec, ist, cells)), refill_i)
    # B13: config 4's spec (p50 and p99 on one histogram), an arena of
    # 2^17 slots, 6,250 named slots padded to 8,192
    sspec = sl.SessionSpec(aggs=tuple(cs.session_plan()[0].aggs))
    ar = sl.session_plane_np(sspec, SESS_CAP)
    ar["code"][:] = np.arange(SESS_CAP)
    for _i, name, _agg in sl._owners(sspec):
        p = ar[name]
        hit = rng.random(p.shape) < 0.05
        p[:] = np.where(hit, rng.integers(1, 9, p.shape), 0)
    arena = {k: torch.from_numpy(v).to(dev) for k, v in ar.items()}
    sel = lattice.pad_slots(np.sort(rng.choice(   # ascending, as the
        SESS_CAP, SESS_LIVE, replace=False)).astype(np.int32))  # mirror's
    ms("B13 session extract", lambda: sl.session_extract(sspec, arena, sel))
    # the session step's launch: a batch of the session path's shape
    spec_all, _schema, layout, sprogs = cs.session_spec_all()
    sa = sl.init_session_arena(spec_all, 1 << 16, dev)
    so = sl.init_session_arena(spec_all, 1 << 16, dev)
    packed = cs.session_batch(dev, spec_all, layout, 60, 1 << 16, 400, 0)
    inputs = sl.session_inputs(spec_all, layout, packed, sprogs)
    ms("session step", lambda: sl.session_step(
        spec_all, sa, so, packed, inputs, cs.SESS_GAP, -(1 << 30), 0))
    return out


def _remap() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.kernels import binding as kb
    from hstream_tpu_torch.engine.kernels import build as kbuild

    built = kbuild.build()
    dev = torch.device("cuda", 0)
    out = {"ptxas": _ptxas(built.log, ("session_remap.cu", "rebase.cu"))}

    def ms(name, fn):
        dev_ms, call_ms, _src = cs.kernel_ms(fn, 100)
        out[name], out[name + ", call"] = dev_ms, call_ms
        d = cs.profiled_calls(fn, 5, name)
        out[name + " by kernel"] = (None if d is None else {
            k: v / 5e3 for k, v in d.items()})

    rng = np.random.default_rng(21)
    sent = 1 << 22
    code = rng.integers(0, 1 << 16, 1 << 17).astype(np.int32)
    code[rng.random(1 << 17) < 0.1] = sent
    arena = {"code": torch.from_numpy(code).to(dev)}
    lut = torch.from_numpy(rng.permutation(1 << 16).astype(np.int32)).to(dev)
    ms("B14 session", lambda: sl.session_remap(arena, lut))
    table = torch.from_numpy(np.cumsum(rng.random(1 << 20) < 0.7)
                             .astype(np.int32)).to(dev)
    flush = torch.empty(1 << 24, dtype=torch.int32, device=dev)
    for name, cap, live in (("B14 join 2^21", 1 << 21, 1 << 21),
                            ("B14 join 2^22", 1 << 22, 1 << 21)):
        c = np.full(cap, sent, np.int32)
        c[:live] = np.sort(rng.integers(0, 1 << 20, live))
        store = {"code": torch.from_numpy(c).to(dev)}
        ms(name, lambda: sl.session_remap(store, table, sent_above=True))
        # cold: a 64 MiB write before each call evicts the plane and the
        # table from L2 (its time is in " by kernel", apart)
        ms(name + " cold", lambda: (flush.fill_(1), sl.session_remap(
            store, table, sent_above=True)))
    from hstream_tpu_torch.parallel import lattice as pl

    here = _here_chip_smoke()
    arenas = here.p15_inputs(dev)[1]
    planes = [{"code": a["code"]} for a in arenas]
    codes = torch.cat([p["code"] for p in planes]).cpu().numpy()
    lut4 = torch.from_numpy(here._residue_lut(
        codes[codes < 1 << 17], len(planes), 1 << 17, rng)).to(dev)
    ms("B19c sharded remap", lambda: pl.sharded_session_remap(planes, lut4))
    del arenas
    for w in (3, 8):
        ss = torch.arange(w, dtype=torch.int32, device=dev) * 10_000
        ss[1] = lattice.EMPTY_START
        st = {"slot_start": ss}
        ms(f"B4 rebase W={w}", lambda: lattice.rebase(st, 0))
    lib = kb.lib()
    if hasattr(lib, "hs_empty"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ms("empty kernel", lambda: kb.check(lib.hs_empty(stream), "empty"))
    else:
        out["empty kernel"] = None
    return out


def _unpack() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import build as kbuild

    built = kbuild.build()
    dev = torch.device("cuda", 0)
    out = {"ptxas": _ptxas(built.log, ("unpack.cu",))}

    def ms(name, fn):
        dev_ms, call_ms, _src = cs.kernel_ms(fn, 100)
        out[name], out[name + ", call"] = dev_ms, call_ms
        d = cs.profiled_calls(fn, 5, name)
        out[name + " by kernel"] = (None if d is None else {
            k: v / 5e3 for k, v in d.items()})

    head = cs.headline_packed(dev)
    lay, nk = (("temp", "f32"),), (None, "__null_a1", "__null_a2")
    ms("B10 unpack", lambda: lattice.unpack(head, lay, nk))
    try:
        from hstream_tpu_torch.parallel import lattice as pl
    except ImportError:
        out["B19a block unpack"] = None
    else:
        half = head.shape[1] // 2
        ms("B19a block unpack", lambda: pl.unpack_block(
            head, half, half, lay, nk, [0, 512]))
    return out


def _session() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.kernels import build as kbuild

    built = kbuild.build()
    dev = torch.device("cuda", 0)
    out = {"ptxas": _ptxas(built.log, ("session_step.cu",
                                       "session_merge.cu"))}

    def ms(name, fn):
        dev_ms, call_ms, _src = cs.kernel_ms(fn, 10)
        out[name], out[name + ", call"] = dev_ms, call_ms
        d = cs.profiled_calls(fn, 3, name)
        out[name + " by kernel"] = (None if d is None else {
            k: v / 3e3 for k, v in d.items()})

    node, _schema = cs.session_plan()
    spec = sl.SessionSpec(aggs=tuple(node.aggs))
    layout = (("lat", "f32"),)
    rng = np.random.default_rng(23)
    arena = cs.random_arena(spec, SESS_CAP, dev, 24)
    dead = torch.from_numpy(rng.random(SESS_CAP) < 0.6).to(dev)
    arena["code"][dead] = sl.SESSION_SENT_CODE
    n = BATCH
    packed = torch.from_numpy(sl.pack_batch_host(
        n, n, rng.integers(0, 100_000, n).astype(np.int32),
        rng.integers(0, 1000, n), None,
        {"lat": np.abs(rng.normal(50, 20, n)).astype(np.float32)},
        [None, None], layout)).to(dev)
    inputs = sl.session_inputs(spec, layout, packed)
    spare = sl.init_session_arena(spec, SESS_CAP, dev)
    ms("B11 session step", lambda: sl.session_step(
        spec, arena, spare, packed, inputs, 5000, -(1 << 30), 0))
    seg = cs.session_seg(dev, spec, 25, 181_072, 100_000, 0)
    ms("B12 session merge", lambda: sl.session_merge(
        spec, arena, spare, seg, 5000, -(1 << 30), 0))
    del arena, spare, seg
    from hstream_tpu_torch.parallel import lattice as pl

    # 15a's inputs from this checkout's chip_smoke, over the timed tree's
    # package
    spec4, arenas, packed4, inputs4, seg4 = _here_chip_smoke().p15_inputs(
        dev)
    outs = [sl.init_session_arena(spec4, a["code"].shape[0], dev)
            for a in arenas]
    ms("B19c sharded step", lambda: pl.sharded_session_step(
        spec4, arenas, outs, packed4, inputs4, 5000, -(1 << 30), 0))
    ms("B19c sharded merge", lambda: pl.sharded_session_merge(
        spec4, arenas, outs, seg4, 5000, -(1 << 30), 0))
    return out


def _sharded() -> dict:
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import build as kbuild
    from hstream_tpu_torch.parallel import lattice as pl

    built = kbuild.build()
    dev = torch.device("cuda", 0)
    here = _here_chip_smoke()
    out = {"ptxas": _ptxas(built.log, ("close.cu", "shard_merge.cu",
                                       "touched.cu", "session_extract.cu"))}

    def ms(name, fn, less=(0.0, 0.0)):
        dev_ms, call_ms, _src = cs.kernel_ms(fn, 50)
        out[name], out[name + ", call"] = dev_ms - less[0], call_ms - less[1]
        d = cs.profiled_calls(fn, 5, name)
        out[name + " by kernel"] = (None if d is None else {
            k: v / 5e3 for k, v in d.items()})

    # B19a's merged close and B19d at config 1's shape: SH_MESH's four
    # partials of 512 keys, one due slot
    c1 = here.sharded_specs()["config 1"]
    st = here.random_sharded_state(c1, dev, 500)
    slot = lattice.pad_slots([0])
    ms("B19a merged close", lambda: pl.close_merged(c1, st, slot))
    ms("B19a merged close extract only", lambda: pl.close_merged(
        c1, st, slot, lattice.CLOSE_EXTRACT))
    st = here.random_sharded_state(c1, dev, 700)
    ms("B19d snapshot merge", lambda: pl.merge_partials(c1, st))
    c16 = here.replace(c1, n_keys=64)
    st = here.random_sharded_state(c16, dev, 710, (2, 16))
    try:
        ms("B19d snapshot merge 2x16", lambda: pl.merge_partials(c16, st))
    except (IndexError, RuntimeError, ValueError) as e:
        out["B19d snapshot merge 2x16"] = f"{type(e).__name__}: {e}"
    del st

    # B19a at the push query's shape: the (2, 2) mesh's partials of
    # 512 keys, one window's cells touched (a second's 2^20 batch)
    spec = here.push_spec(512)
    st = here.random_sharded_state(spec, dev, 600)
    mo = spec.n_keys * spec.n_slots

    def retouch():
        for row in st:
            for p in row:
                p["touched"][:, 0] = True

    for row in st:
        for p in row:
            p["touched"].zero_()
    less = cs.kernel_ms(retouch, 50)[:2]
    ms("B19a merged touched push", lambda: (retouch(), pl.touched_merged(
        spec, st, mo)), less)
    # the single-card extract (B6's one launch) of the same query over
    # the whole lattice (1024 keys), the same window's cells touched
    one = lattice.init_state(here.push_spec(1024), dev)

    def retouch_one():
        one["touched"][:, 0] = True

    less = cs.kernel_ms(retouch_one, 50)[:2]
    ms("B6 touched push", lambda: (retouch_one(), lattice.extract_touched(
        here.push_spec(1024), one, 1024 * spec.n_slots)), less)
    # B19a at 15b's shape (this checkout's p15_touched_inputs)
    jspec, jst, jmo = here.p15_touched_inputs(dev)
    saved = [[p["touched"].clone() for p in row] for row in jst]

    def refill():
        for row, srow in zip(jst, saved):
            for p, s in zip(row, srow):
                p["touched"].copy_(s)

    less = cs.kernel_ms(refill, 20)[:2]
    ms("B19a merged touched 15b", lambda: (refill(), pl.touched_merged(
        jspec, jst, jmo)), less)
    del jst, saved
    # B19c at 15a's inputs (this checkout's p15_inputs and slot lists)
    spec4, arenas, _packed, _inputs, _seg = here.p15_inputs(dev)
    slots = here.p15_extract_slots(arenas)
    ms("B19c sharded extract", lambda: pl.sharded_session_extract(
        spec4, arenas, slots))
    return out


def _ptxas(log: str, sources) -> dict:
    """{source: [ptxas lines]}: each kernel's function properties
    (stack frame, spills) and registers, from nvcc's -Xptxas -v output
    ("" when the library was already built)."""
    out, cur = {}, None
    for line in log.splitlines():
        if line.startswith("== "):
            cur = line[3:].strip()
            continue
        if cur in sources and ("Compiling entry" in line
                               or "Function properties" in line
                               or "stack frame" in line
                               or "registers" in line):
            out.setdefault(cur, []).append(line.strip())
    return out


GROUPS = {"scatter": _scatter, "join": _join, "decode": _decode,
          "expr": _expr, "close": _close, "remap": _remap,
          "unpack": _unpack, "session": _session, "sharded": _sharded}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tree":
        tree = os.path.abspath(sys.argv[3])
        sys.path.insert(0, tree)
        os.chdir(tree)
        print("AB", json.dumps(GROUPS[sys.argv[2]]()), flush=True)
        return 0
    if len(sys.argv) != 3 or sys.argv[1] not in GROUPS:
        print(__doc__, file=sys.stderr)
        return 2
    group = sys.argv[1]
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(sys.argv[2])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for tree in (other, here, here, other):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", group, tree], capture_output=True,
                             text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        line = [x for x in run.stdout.splitlines() if x.startswith("AB ")]
        print(f"AB {tree} {line[-1][3:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
