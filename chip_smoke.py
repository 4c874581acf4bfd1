#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hstream_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero):

1. card: the card's name and power limit, torch and CUDA versions;
2. build: the kernels from engine/kernels/csrc (one nvcc per source,
   all started together);
3. kernels vs plain: every kernel against its plain PyTorch version on
   the same inputs on the card, and timed at the main paths' shapes
   beside its plain version, its bound and, where one exists, PyTorch
   calls computing the same function: wire decode, scatter (every
   lattice the paths step, scatter_specs(), in each mode it can take:
   block-private, cluster and global; keys below 0 and at K + 5, a batch
   crossing a window end, subnormal inputs, the join's inner lattice at
   K = 2^19 on a match-sized feed), fused close
   (all three modes; random lattices of every aggregate kind at HLL p
   of 4, 10 and 14 over 1000 keys, scalars and TOPK over 1003 keys, and
   8643 slots over 13 keys, with slot vectors of one and of 8,192,
   pads among them, every mode twice in a row), rebase (at 1-8641
   slots, timed beside an empty kernel on the same stream, the floor of
   a launch), and the
   changelog query's kernels (the
   expression interpreter over every op and type mix, programs that
   spill, batches of 2^16 and 2^16 - 3 records, aligned and one element
   off; program sets past one argument block: 24 programs over 20
   columns with a WHERE, a program over 80 columns and one of ~500
   instructions, each cut into pieces; NULL masks,
   COUNT(col) and quantile bins in the scatter and estimates in the
   close; the top-k fold; the touched extract in both its modes, one
   launch and staged, on every aggregate kind and on scalars alone, with
   n = 0, n = and > max_out, lattices of 4096 and 4097 cells and of
   several tiles, then again at the join's shape; the reset-only close),
   the expression kernel's 21 unaries on every operand type the
   reference takes (NaN, +-inf, +-0, subnormals flushed where the
   reference flushes them, x.5 and -x.5, inputs outside the
   domains of SQRT, the logs, ASIN, ACOS, ACOSH and ATANH, large SIN,
   COS and TAN arguments; CEIL, FLOOR, ROUND, SIGN and SQRT exact, the
   rest within CARD_ULP), then phase 11's programs on a batch of its
   stream against their plain versions (the WHERE mask, ROUND and CEIL
   bit for bit, the LOG10 and EXP inputs within CARD_ULP) and timed
   there, and the session
   kernels (the step and the merge over every aggregate
   kind, out-of-order records gap and gap + 1 apart, equal starts,
   evicted and retired arena entries, a non-zero delta, NULLs, NaN,
   +-inf and +-0.0, keys all in one bucket of the sort or in its low
   byte only, codes at 2^22 - 1 beside sentinels, starts on both sides
   of the int32 wrap, fewer entries than one sort tile, no arena slots,
   no batch records; the extract with pads, empty histograms and HLL
   estimates near .5, then random arenas of config 4's spec, of every
   kind at HLL p of 4, 10 and 14 and of nine quantiles sharing one
   histogram, over slot vectors of one and of 8,192; the remap with codes at and above the table,
   then at the session arena's 2^17 and the join store's 2^21 codes,
   each with a tail of 3 and on bases 4, 8 and 12 bytes past a 16-byte
   boundary, with the sentinel flag both ways, timed at 2^21), and
   the join kernels (the probe + merge-insert and the probe alone at a
   match_cap below and above the total, in each probe branch forced:
   the store window staged in shared memory, searched in global memory,
   the whole store; a staged window, a skewed key, ts -+ within wrapping
   int32, records whose matches span several tiles; the fused probe +
   window step over feed sources m, o, both and both_o with null and
   present bits on both sides, filter-NULL columns, a WHERE and
   subnormal columns, in each branch; the two-sided
   eviction with delta 0, > 0 and < 0, stores below one tile, off the
   tile, over many, every slot live, every entry dead, none resident;
   equal (code, ts) runs across
   store and batch, sentinels that kept their columns, entries below the
   cutoff, negative times, n = 0; the remap kernel's sentinel flag),
   and the packed transport's unpack (bool, i32 and f32 columns, NULL
   masks behind a leading COUNT(*), padding past n, NaN and +-0.0) with
   the whole packed step, and the per-slot extract and reset on every
   slot of three lattices;
4. main path, config 1 (BASELINE 1/3): COUNT(*), SUM(temp),
   APPROX_COUNT_DISTINCT(temp) GROUP BY device, TUMBLE(10s) over 1000
   keys, 2^20-record batches through IngestPipeline past two window
   closes, checked against a numpy reference; then close-latency
   samples, the first of which rebases the epoch;
5. main path, config 2 (BASELINE 2): HOP(60s,10s) AVG/MIN/MAX over 1000
   keys, the same way; (5b) a query past the port's old caps, 24
   aggregates over 20 columns with a WHERE, computed inputs a chain of
   40 additions, a nest of 20 and a sum of 64 products (two argument
   blocks of the expression kernel a batch), 10 batches of 2^16 records
   over 64 keys through IngestPipeline, every closed row against numpy;
6. the changelog path: SELECT device, COUNT(temp), SUM(temp * 1.8 + 32),
   APPROX_QUANTILE(temp, 0.99), TOPK(temp, 3), TOPK_DISTINCT(temp, 3)
   FROM sensors WHERE temp > 15.0 GROUP BY device, TUMBLE(10s) EMIT
   CHANGES, over config 1's stream with a 1 % NULL mask on temp, through
   IngestPipeline with deferred, asynchronous change drains; every
   changelog row against a numpy reference of the running values, and
   the launch contract (per batch one decode, expression, scatter, top-k
   and touched extract; per close cycle one reset-only close, no fetch);
7. the session path, BASELINE config 4 (bench.py:340-356): SELECT
   user, APPROX_QUANTILE(lat, 0.5), APPROX_QUANTILE(lat, 0.99) FROM s
   GROUP BY user, SESSION(5 s) through SessionExecutor.process_columnar
   in record mode with deferred closes drained every 8 batches, over
   48 x 2^20 records from 100,000 user slots (on 8 s, off 8 s, fresh
   ids at 3/4 of the on-phases, so the key dictionary passes 2^18 and
   the code remap runs); every closed session against a numpy
   reference (user, bounds exact, p50/p99 bucket), the launch contract
   (one step per batch, one extract per close cycle, one fetch per
   drain and buffer shape, a remap, no move to the host engine); then
   the first 12 batches in segment mode (the merge kernel); a profiled
   window of 8 more batches; each session kernel timed at the path's
   shapes;
8. the join path, BASELINE config 5 (bench.py:453-567): SELECT l.k,
   COUNT(*) FROM l INNER JOIN r WITHIN (1 s) ON l.k = r.k GROUP BY l.k,
   TUMBLING (10 s) EMIT CHANGES through JoinExecutor.process_columnar
   with bench.py's knobs, 14 warm-up and 12 timed batches of 2^20
   records over 512,000 keys (sides alternating, 500 ms of stream each);
   every final change per (key, window) against a numpy count of the
   pairs, the launch contract (one fused probe wrapper call per device
   batch, no match fetch, an eviction, the device path kept); freshness
   samples and a profiled window of 8 batches; then (8b) the match-fetch
   path, SUM(l.x) over WITHIN 10 s and TUMBLE(1 s) at 2^16-record
   batches, match buffers fetched stacked; and each join kernel held
   against its plain version on one call kept from these paths and
   timed there;
9. (9a) config 1's stream packed by lattice.pack_batch_host into pinned
   buffers, uploaded and stepped by compiled(...).step (the unpack
   kernel, then the scatter), each due window closed by extract_slot then
   reset_slot, rows against numpy; (9b) config 2 through IngestPipeline
   with the per-slot close (`_fused_close_ok = False`), then a watermark
   jump that closes the six windows still open, several in a cycle: rows
   against numpy, two launches and one fetch per window;
10. SQL text to a restored query: (a, b) CREATE STREAM ... AS SELECT
   device, COUNT(*), SUM(temp), APPROX_COUNT_DISTINCT(temp) ... TUMBLING
   (10 s) GRACE 0 EMIT CHANGES lowered by the port's stream_codegen and
   built by make_executor, config 1's 101 batches through IngestPipeline;
   at batch 25 the changelog is flushed, the executor captured, stepped
   once more, serialized, sealed, opened and restored on the card, and
   the restored one continues: its changelog equals an uninterrupted
   run's row for row, every final change equals numpy; (c) a session
   snapshot (config 4's query as a CREATE VIEW, cut to 10,000 user slots
   and 8 batches) and a join snapshot (phase 8b's query and size), each
   from SQL text, restored, re-activated on the card and equal to an
   uninterrupted run;
11. from the durable log: a native store under a temporary directory
   (open_store("file://...")), a stream `sensors`, config 1's stream as
   columnar records of 2^16 rows, 16 to a 2^20-record batch, 56 batches
   appended (~0.9 GB); read back by a CheckpointedReader over a
   FileCheckpointStore, decoded (columnar.decode_columnar_nulls, a key id
   per device string as the server's query task does) and stepped
   through IngestPipeline by LOG_SQL (WHERE SQRT(ABS(temp)) > 4.0, SUM
   of LOG10, AVG of EXP, MAX(ROUND), MIN(CEIL)); at batch 25 the
   checkpoint is written and the query snapshotted, the store closed and
   reopened, the query restored and the reader resumed; then 8 batches of
   2^16 JSON records (records.build_record) through the store and the
   native decoder (jsondec.decode_batch) into the same query, past the
   second window's end. Closed rows equal an uninterrupted run's and
   numpy's; append, read and decode seconds, events/s from the log to
   rows and the device busy share are printed;
12. kernel-family tracing and fault points: config 1 for 16 batches of
   2^20 records (one 10 s window each) through QueryExecutor, config 4's
   stream for 8 batches (4 s of stream each) through SessionExecutor and
   phase 8b's join for 12 batches, with DEVICE_TIME armed at rate 4:
   the `step`, `close`, `session` and `probe` rings' p50 and p99 (with
   2-4 samples a ring, the p99 is the ring's max, printed so) beside
   the profiled kernel times of the same shapes (every sampled step at
   least the profiled decode plus scatter); a RetraceGuard over the
   steady batches counts 0; device.dispatch, device.activate,
   device.fetch and device.session.dispatch fired once each raise and
   leave the planes byte-equal to a clone, and the rows then equal
   numpy; a disarmed rerun leaves the sampler empty; what a sample
   reads around an empty kernel, and a step's host time inside its scope
   beside its samples with the card idle or kept busy through the
   host's encode (step_split);
13. the single-node server (bench.py:768's served path): the port's
   serve("127.0.0.1", 0, "mem://", device_time_sample=4) on the card,
   driven over loopback through its gRPC stub: stream `sensors`, the
   headline view (config 1's query as CREATE VIEW, TUMBLING (10 s)
   GRACE 0) and bench.py:768's push query (COUNT(*), SUM(temp) ... EMIT
   CHANGES); config 1's stream as framed AppendColumnarStream blocks of
   2^18 records (client.producer.encode_batch, 500 ms of stream a
   block), three runs of 64 blocks, each timed from the append to both
   queries' drained watermark (server_columnar_eps, bench.py's name), a
   pull query of the view in the quiet after 30 blocks and pulls taken
   while the rest of the first run is ingested (the extract-only close,
   B3, on a main path), a profiled window of 12 blocks; every window of
   the final pull, every pull during ingest over the whole-block prefix
   its counts name, and every (device, window)'s last change of the push
   query equal numpy; both executors on the card, no move to a host
   engine, and the decode, scatter, fused close, extract-only close,
   reset-only close and touched extract launched; kernel_device_ms p50
   per family read from /metrics; then a server over a file:// store
   under a temporary directory stops after 30 blocks with its task
   detached, a second one over the same store restores the view's
   snapshot on the card and ingests 18 more: its rows equal numpy and
   the uninterrupted run's;
14. the sharded window lattice, four shards on the one card (a (2, 2)
   mesh, hstream_tpu_torch.parallel): in phase 3, the block unpack,
   the merged close (modes 0, 1 and 2 and per slot), the merged
   changelog extract and the snapshot merge against their plain
   versions, exact; the merged extract also on meshes (2, 2), (1, 4),
   (4, 1) and (2, 3) in its one launch and staged (max_out cuts, fill
   columns, a key shard touched nowhere, every kind a mesh takes), and
   with the merged close on (2, 16) and (1, 24), which pass the 16
   partials one launch reads and run as two launches; 14a configs 1 and
   2 through ShardedQueryExecutor,
   24 batches of 2^20 records (2^19 a data shard, 1 s of stream each)
   and a closer: every closed row equals numpy and the single-card
   QueryExecutor's, one merged close launch and one fetch a cycle;
   14b bench.py:768's push query on the mesh, every (key, window)'s last
   change equal numpy; 14c serve(mesh_shape="2x2") serving phase 13's
   view and push query over 16 framed blocks of 2^18 records, a pull
   and the push finals equal numpy, then the view's snapshot taken on
   the mesh restored onto one card and that one's restored onto a mesh,
   both equal numpy. events/s of four shards on one card are printed as
   a diagnostic;
15. the key-sharded session arena and join stores on the one card
   (B19c, B19b): in phase 3, the sharded session step and merge over
   one table of the card's key shards and over split tables (every
   aggregate kind), timed at 15a's shapes, the extract over four slot
   lists (one table and split ones, the named prefixes by value and
   uploaded), the remap through one residue-preserving table, the sharded
   probe + insert, probe-only, fused step into (D, K) inner lattices,
   the table scatter and the eviction against their plain versions;
   15a config 4 at phase 7's widths (phase 7's stream, 100,000 user
   slots, 2^20 records a batch) through SessionExecutor on
   make_mesh(1, 4), 16 record batches (the key-cache bound lowered, so
   residue-preserving compactions run) and 12 segment batches, every
   closed session equal numpy and phase 7's single-card rows; 15b config
   5 at phase 8's widths on make_mesh(2, 2), 12 batches (10 past
   activation, fused, with evictions), every final change equal numpy
   and phase 8's single-card finals after as many batches; 15c phase
   8b's query and size on the mesh, one overflow provoked so the
   probe-only redispatch runs, every final change equal numpy; 15d
   serve(mesh_shape="2x2") serving a session view over 16 framed
   blocks, its closed sessions equal numpy, then its snapshot restored
   onto one card and back onto a mesh, each resuming equal to numpy.
   Each new kernel is then held against its plain version at its
   path's shapes and timed (the merged changelog extract also at 15b's
   inner lattice, captured at its last batch); events/s are printed as
   a diagnostic;
16. the replicated server, failed over (its section below says how);
17. the cluster layer on the card (hstream_tpu_torch/placer): 17a
   serve(pack_queries=True) with three push queries of one signature at
   config 1's width sharing one pack group's executor and a fourth that
   packing refuses (a WHERE, EXPLAIN's PACK line naming the filter) as a
   standalone task, over 24 framed blocks of 2^16 records (1 s of stream
   each) and a closer, then one member terminated and 4 more blocks and
   a closer: one group of three members in the pool and the admin placer
   verb, its executor and planes on the card with no move to a host
   engine, RetraceGuard 0 over members 2 and 3 attaching and streaming,
   ceil(members x n / 4096) decode and scatter launches a feed of n
   records (on every feed before the refused query's task starts
   stepping beside the group), and every member's and the refused
   query's last change of each (device, window) equal numpy; the three
   queries unpacked on a server of their own are a diagnostic (their
   rows against numpy, events/s and launches a block); 17b three armed
   nodes over one shared store (placer tick 100 ms, a 2000 ms heartbeat
   lease), one push query placed by the placer, 12 blocks of 2^16 with
   the owner killed crash-style after block 6: exactly one survivor
   adopts on the lapsed lease, never two owners at any 10 ms sample, it
   resumes from the snapshot on the card, no self-fence, and the sink's
   last changes equal numpy; the seconds from the kill to the adoption
   and to the adopter's first row are printed;
18. a "phase wall s {...}" line (each phase's wall seconds, also logged
   as each phase ends), a {"kernels": [...]} line (each kernel's
   launches on the main paths, its error against the plain version and
   its times), the card line, and last {"ok": true, "device": {...}}.

Device times come from torch.profiler over repeated calls, warmed by
spin kernels it leaves out; a profile whose per-kernel event counts are
not multiples of the calls, or that lacks a kernel the call must
launch (the rows of phase 15 and of this port's newest kernels name
theirs), is not used, and CUDA events time the calls instead
(profiled_calls).

Inputs come from fixed seeds with numpy. Tolerances: integer planes,
slot_start, HLL registers and estimates, quantile bins and estimates,
top-k planes, MIN/MAX, counts, expression results and every packed close
and changelog row are exact. SUM/AVG accumulators add with float atomics
in an order that changes from run to run; two summation orders of n
terms differ by at most 2*n*2^-24*sum|x|, the bound each SUM cell (and
each AVG cell's sum) is held to. The changelog path's quantile estimates
may sit one bucket from numpy's only for a key whose data holds a value
within one float32 ulp of a bin edge (numpy's log is not the card's);
the run reports how many; the session path's p50/p99 likewise. The
session kernels' code, t0, t1, integer planes, HLL registers, histograms
and extract rows are exact, MIN/MAX by value, SUM/AVG within the same
order bound per slot (n the terms folded into it). The join kernels'
match buffers, stores and live counts are exact, and so are the fused
step's state planes (its phase-3 inputs are multiples of 1/4, its path
holds counts only); the join paths' counts are exact, 8b's SUM within
the order bound. The unpack, the packed step on its awkward batch (its
sums are exact in any order), the per-slot extract and reset are exact;
phase 10's restored changelog has exact counts and HLL estimates and
SUMs within twice the order bound of the uninterrupted run's, its
sessions and join finals are exact (the join's SUM within the order
bound of numpy's). Phase 11's counts, MAX(ROUND) and MIN(CEIL) are
exact, its SUM and AVG within the order bound plus CUDA's documented ULP
bound of each term's function. Details go to smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import types
from dataclasses import replace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
U = 2.0 ** -24              # float32 unit roundoff

N_KEYS = 1000
BATCH = 1 << 20
STREAM_MS_PER_BATCH = 200
N_UNIQUE = 8
MAIN_BATCHES = 101          # window closes after batches 50 and 100
CLOSE_SAMPLES = 3
BASE_TS = 1_700_000_000_000
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _device_us(event) -> float:
    """An event's own device time; 0 for a host-side (CPU) event, whose
    self device time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType

    if getattr(event, "device_type", None) == DeviceType.CPU:
        return 0.0
    v = getattr(event, "self_device_time_total", None)
    return v if v is not None else getattr(event, "self_cuda_time_total", 0.0)


def _profile(fn):
    """(fn's result, {device event name: device us}, {device event name:
    events recorded}) with fn run under torch.profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler loses the first few device events of a profile
        # (seven on an H100, PERF.md): spend them on spin kernels, which
        # are left out below
        for _ in range(_WARM_KERNELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "spin_kernel" not in e.key]
    counts = {e.key: e.count for e in events
              if getattr(e, "device_type", None) == DeviceType.CUDA}
    return out, {e.key: _device_us(e) for e in events
                 if _device_us(e) > 0}, counts


_WARM_KERNELS = 32


def profiled(fn):
    """(fn's result, {device event name: device us}) with fn run under
    torch.profiler's CUDA activity."""
    out, dev, _counts = _profile(fn)
    return out, dev


def profiled_calls(fn, iters: int, what: str = "",
                   expect: tuple = ()) -> dict | None:
    """{device event name: device us} of `iters` calls of fn, or None
    when the profiler lost events: one call launches each of its
    kernels (and copies and fills) a fixed number of times, so each
    device event must be recorded a multiple of `iters` times, and each
    name in `expect` (a part of a device event's name: the kernels the
    call must launch) must be among them, since a kernel dropped whole
    leaves no count to test; the profile is taken twice before it is
    given up. The profiler drops events now and then, and a short sum
    would pass for a fast kernel."""
    for _attempt in range(2):
        _, dev, counts = _profile(lambda: [fn() for _ in range(iters)])
        short = {k: c for k, c in counts.items() if c % iters}
        missing = [e for e in expect if not any(e in k for k in counts)]
        if counts and not short and not missing:
            return dev
    log(f"profiler: events lost over {iters} calls of {what or 'a call'} "
        f"({len(short)} kernels recorded a count that is not a multiple "
        f"of {iters}, {len(counts)} kernels in all; expected but missing: "
        f"{missing}): not used")
    return None


def kernel_ms(fn, iters: int, expect: tuple = ()) -> tuple[float, float,
                                                           str]:
    """(ms, call_ms, source): the device time per call of fn from
    torch.profiler (the kernels and copies it launches, without the
    host's gaps between launches; "events" when the profiler lost,
    recorded no or missed an `expect`ed event, profiled_calls), and the
    time per call with CUDA events around many calls, which for a short
    kernel is the host's launch path and is then also the first
    number."""
    call = cuda_time_ms(fn, iters)
    dev = profiled_calls(fn, iters, getattr(fn, "__name__", ""), expect)
    total = sum(dev.values()) if dev is not None else 0.0
    if total <= 0:
        return call, call, "events"
    return total / 1e3 / iters, call, "profiler"


def kernel_only_ms(fn, iters: int, name, expect: tuple = ()
                   ) -> float | None:
    """Device ms a call of the kernels whose event names hold `name` (a
    string, or a tuple of them: any), from a profile of `iters` calls of
    fn (which may launch other work, such as a write that evicts L2; its
    events are left out); None where the profile lost events or missed
    one of `expect`."""
    names = (name,) if isinstance(name, str) else tuple(name)
    dev = profiled_calls(fn, iters, names[0], expect)
    if dev is None:
        return None
    return sum(us for k, us in dev.items()
               if any(n in k for n in names)) / 1e3 / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs operations over
    the float32 rate, in ms, and which one bounds it."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def _wrappers() -> dict:
    """Each kernel's wrapper, whose .launches counts its launches."""
    from hstream_tpu_torch.engine import expr, lattice, transport
    from hstream_tpu_torch.engine import join_lattice as jl
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.parallel import lattice as pl

    return {"wire_decode": transport.decode_batch,
            "unpack": lattice.unpack,
            "expression": expr.eval_programs,
            "scatter_aggregate": lattice.scatter_step,
            "topk_fold": lattice.topk_step,
            "fused_close": lattice.close_slots,
            "reset_close": lattice.reset_slots,
            "extract_slot": lattice.extract_slot,
            "reset_slot": lattice.reset_slot,
            "touched_extract": lattice.extract_touched,
            "rebase": lattice.rebase,
            "session_step": sl.session_step,
            "session_merge": sl.session_merge,
            "session_extract": sl.session_extract,
            "session_remap": sl.session_remap,
            "join_probe_insert": jl.join_probe_insert,
            "join_probe_only": jl.join_probe_only,
            "join_probe_step": jl.join_probe_insert_step,
            "join_evict": jl.join_evict,
            "sharded_step": pl.unpack_block,
            "merged_close": pl.close_merged,
            "merged_close_slot": pl.close_slot_merged,
            "merged_touched": pl.touched_merged,
            "shard_merge": pl.merge_partials,
            "sharded_session_step": pl.sharded_session_step,
            "sharded_session_merge": pl.sharded_session_merge,
            "sharded_session_extract": pl.sharded_session_extract,
            "sharded_session_remap": pl.sharded_session_remap,
            "sharded_join_probe_insert": pl.sharded_join_probe_insert,
            "sharded_join_probe_only": pl.sharded_join_probe_only,
            "sharded_join_probe_step": pl.sharded_join_probe_insert_step,
            "sharded_join_evict": pl.sharded_join_evict,
            "sharded_join_scatter": pl.scatter_table_cuda}


def launch_counts() -> dict[str, int]:
    """Each kernel's launches; "expression_unaries" counts the expression
    kernel's launches whose programs ran a unary (B1b')."""
    from hstream_tpu_torch.engine import expr

    from hstream_tpu_torch.engine import lattice

    out = {name: fn.launches for name, fn in _wrappers().items()}
    out["expression_unaries"] = expr.eval_programs.unary_launches
    # the close wrapper's extract-only launches (B3, a peek) apart from
    # its closes (B2)
    out["extract_close"] = lattice.close_slots.extract_launches
    out["fused_close"] -= out["extract_close"]
    return out


def zero_counts() -> None:
    from hstream_tpu_torch.engine import expr, lattice

    for fn in _wrappers().values():
        fn.launches = 0
    expr.eval_programs.unary_launches = 0
    lattice.close_slots.extract_launches = 0


# ---- the two configurations -------------------------------------------------

def make_spec(cfg: int):
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.expr import Col
    from hstream_tpu_torch.engine.plan import AggKind, AggSpec
    from hstream_tpu_torch.engine.window import HoppingWindow, TumblingWindow

    if cfg == 1:
        win = TumblingWindow(10_000, grace_ms=0)
        aggs = (AggSpec(AggKind.COUNT_ALL, "cnt"),
                AggSpec(AggKind.SUM, "total", input=Col("temp")),
                AggSpec(AggKind.APPROX_COUNT_DISTINCT, "uniq",
                        input=Col("temp")))
    else:
        win = HoppingWindow(60_000, 10_000, grace_ms=0)
        aggs = (AggSpec(AggKind.AVG, "avg", input=Col("temp")),
                AggSpec(AggKind.MIN, "lo", input=Col("temp")),
                AggSpec(AggKind.MAX, "hi", input=Col("temp")))
    return lattice.LatticeSpec(n_keys=1024, window=win, aggs=aggs,
                               track_touched=False)


# ---- numpy reference (independent of the port) ------------------------------

def np_hll_indices(v: np.ndarray, p: int = 10):
    """(register, rank) of float32 values: murmur3 fmix32 of the bits."""
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    h = v.view(np.uint32).copy()
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    reg = (h >> np.uint32(32 - p)).astype(np.int64)
    x = h << np.uint32(p)
    n = np.zeros(x.shape, np.int64)
    for s in (16, 8, 4, 2, 1):
        empty = (x >> np.uint32(32 - s)) == 0
        n += np.where(empty, s, 0)
        x = np.where(empty, x << np.uint32(s), x)
    clz = np.where(x == 0, 32, n)
    return reg, np.minimum(clz + 1, 33 - p)


class Batches:
    """N_UNIQUE pre-made (kids, temps) pairs, cycled; 200 ms of stream
    time per 2^20-record batch (bench.py's shape); temps are one-decimal
    sensor readings in the wire codec's canonical f32 form."""

    def __init__(self, seed: int, ms: int = STREAM_MS_PER_BATCH):
        rng = np.random.default_rng(seed)
        self.kids = [rng.integers(0, N_KEYS, BATCH).astype(np.int32)
                     for _ in range(N_UNIQUE)]
        self.temps = [(np.rint(rng.normal(20.0, 5.0, BATCH) * 10)
                       .astype(np.float32) * np.float32(0.1))
                      for _ in range(N_UNIQUE)]
        self.ms = ms
        self.ts_template = (np.arange(BATCH, dtype=np.int64) * ms) // BATCH

    def get(self, b: int):
        j = b % N_UNIQUE
        return (self.kids[j], BASE_TS + b * self.ms + self.ts_template,
                self.temps[j])

    def per_key(self) -> list[dict]:
        """Per unique batch and key: count, f64 sum, sum|x|, min, max and
        HLL registers."""
        out = []
        for k, t in zip(self.kids, self.temps):
            t64 = t.astype(np.float64)
            mn = np.full(N_KEYS, np.inf, np.float32)
            mx = np.full(N_KEYS, -np.inf, np.float32)
            np.minimum.at(mn, k, t)
            np.maximum.at(mx, k, t)
            regs = np.zeros(N_KEYS * 1024, np.int8)
            reg, rank = np_hll_indices(t)
            np.maximum.at(regs, k.astype(np.int64) * 1024 + reg,
                          rank.astype(np.int8))
            out.append(dict(
                count=np.bincount(k, minlength=N_KEYS),
                sum=np.bincount(k, weights=t64, minlength=N_KEYS),
                abs=np.bincount(k, weights=np.abs(t64), minlength=N_KEYS),
                min=mn, max=mx, regs=regs.reshape(N_KEYS, 1024)))
        return out


def window_reference(per_key: list[dict], start: int, size: int,
                     ms: int = STREAM_MS_PER_BATCH,
                     batches: int = MAIN_BATCHES) -> dict:
    """Aggregates of the main-path batches (`batches` of `ms` stream ms)
    whose records all lie in [start, start + size)."""
    lo = max(0, -(-(start - BASE_TS) // ms))
    hi = (start + size - BASE_TS) // ms
    parts = [per_key[b % N_UNIQUE] for b in range(lo, min(hi, batches))]
    return dict(
        count=sum(p["count"] for p in parts),
        sum=sum(p["sum"] for p in parts),
        abs=sum(p["abs"] for p in parts),
        min=np.minimum.reduce([p["min"] for p in parts]),
        max=np.maximum.reduce([p["max"] for p in parts]),
        regs=np.maximum.reduce([p["regs"] for p in parts]))


# ---- phase 3: kernels against their plain versions --------------------------

def headline_batch(dev, spec):
    """The main path's step input: one 2^20-record headline batch, wire
    encoded, uploaded, and decoded by the plain version."""
    from hstream_tpu_torch.engine import transport as tp

    rng = np.random.default_rng(3)
    kids = rng.integers(0, N_KEYS, BATCH).astype(np.int32)
    ts = 10_000 + (np.arange(BATCH, dtype=np.int64) * 200) // BATCH
    temps = (np.rint(rng.normal(20, 5, BATCH) * 10).astype(np.float32)
             * np.float32(0.1))
    combo, bases, words = tp.BitpackTransport().encode(
        BATCH, BATCH, kids, ts, {"temp": temps}, (("temp", "f32"),))
    w = torch.from_numpy(words.view(np.int32)).to(dev)
    return w, combo, bases, tp.decode_batch_ref(w, combo, BATCH, BATCH,
                                                bases)


def decode_vs_plain(w, combo, cap: int, n: int, bases, name: str) -> None:
    """The wire-decode kernel bit for bit against its plain version."""
    from hstream_tpu_torch.engine import transport as tp

    got = tp.decode_batch(w, combo, cap, n, bases)
    want = tp.decode_batch_ref(w, combo, cap, n, bases)
    torch.cuda.synchronize()
    for g, r in zip(got[:3], want[:3]):
        assert torch.equal(g, r), f"decode {name}: key/ts/valid differ"
    assert got[3].keys() == want[3].keys(), name
    for col in got[3]:
        g, r = got[3][col], want[3][col]
        assert g.dtype == r.dtype and torch.equal(
            g.view(torch.uint8), r.view(torch.uint8)), \
            f"decode {name}: column {col} differs"


def random_wire(dev, rng, combo, cap: int):
    """(words, bases) of random bits for a combo built by hand: every
    value of every stream is arbitrary, and a 32-bit delta stream's
    running sum wraps past 2^32 again and again."""
    from hstream_tpu_torch.engine import transport as tp

    n_words = sum(p.words(cap) for p in combo)
    words = rng.integers(-(1 << 31), 1 << 31, n_words).astype(np.int32)
    bases = [int(b) for b in rng.integers(-(1 << 30), 1 << 30, len(combo))]
    assert tp.wire_bytes(combo, cap) == 4 * n_words
    return torch.from_numpy(words).to(dev), bases


def wide_combo(delta: bool):
    """16 streams, the kernel's most: keys, timestamps (delta-packed or
    not), __valid, and 13 columns over every encoding."""
    from hstream_tpu_torch.engine.transport import StreamPlan as P

    return (P("__kid", "bp", bits=10),
            P("__dt", "bpd" if delta else "bp", bits=32 if delta else 20),
            P("__valid", "bool1"),
            P("b0", "bp", bits=0), P("b3", "bp", bits=3),
            P("b5", "bp", bits=5), P("b12", "bp", bits=12),
            P("b28", "bp", bits=28), P("b32", "bp", bits=32),
            P("f1", "bool1"), P("f2", "bool1"),
            P("d10", "dec", scale=10, bits=16),
            P("d100", "dec", scale=100, bits=24), P("d1", "dec", scale=1,
                                                   bits=1),
            P("rf", "rawf"), P("ri", "rawi"))


def check_decode(dev, results, head):
    from hstream_tpu_torch.engine import transport as tp

    rng = np.random.default_rng(11)
    cap, n = BATCH, BATCH - BATCH // 97 - 3   # odd n < cap
    kids = rng.integers(0, N_KEYS, n).astype(np.int32)
    ts = np.sort(rng.integers(0, 200, n)).astype(np.int64)
    temps = (np.rint(rng.normal(20, 5, n) * 10).astype(np.float32)
             * np.float32(0.1))
    cases = [("headline", ts, {"temp": temps}, (("temp", "f32"),), None)]
    ladder = tp._BIT_LADDER                   # every bp width, 0 and 32 too
    for part in (ladder[:8], ladder[8:]):     # <= 16 streams per wire
        cols, layout = {}, []
        for b in part:
            if b == 32:
                v = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)
                v[:2] = (-(1 << 30), 1 << 30)
            else:
                v = rng.integers(0, 1 << b, n).astype(np.int64) - 77
                if b:
                    v[0], v[1] = -77, (1 << b) - 1 - 77
            cols[f"w{b}"] = v.astype(np.int32)
            layout.append((f"w{b}", "i32"))
        cases.append((f"ladder{part}", ts, cols, tuple(layout), None))
    wide_ts = np.sort(rng.integers(0, 1 << 31, n)).astype(np.int64)
    cases.append(("raw+bool+valid", wide_ts, {
        "rf": rng.normal(0, 1, n).astype(np.float32),
        "ri": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        "b": rng.integers(0, 2, n).astype(np.bool_),
        "d100": (np.rint(rng.normal(0, 50, n) * 100).astype(np.float32)
                 / np.float32(100)),
    }, (("rf", "f32"), ("ri", "i32"), ("b", "bool"), ("d100", "f32")),
        rng.integers(0, 4, n) > 0))
    encs = set()
    for name, t, c, lay, valid in cases:
        combo, bases, words = tp.BitpackTransport().encode(
            cap, n, kids, t, c, lay, valid=valid)
        encs |= {(p.enc, p.bits) for p in combo}
        w = torch.from_numpy(words.view(np.int32)).to(dev)
        decode_vs_plain(w, combo, cap, n, bases, name)
    assert {"bp", "bpd", "bool1", "dec", "rawf", "rawi"} <= \
        {e for e, _ in encs}, encs
    assert {0, 1, 32} <= {b for e, b in encs if e == "bp"}, encs
    # wires built by hand from random bits: caps that are not a multiple
    # of the kernel's 1024-value tile (down to a partial group of four),
    # a 3 x 2^20-record wire whose 32-bit deltas wrap past 2^32 (more
    # than 32 look-back rounds at any grid), 16 streams, with and
    # without a delta stream
    hand = [("16 streams", wide_combo(True), cap, n),
            ("16 streams, no delta stream", wide_combo(False), cap, n),
            ("cap off the tile", wide_combo(True), BATCH - 333,
             BATCH - 400),
            ("cap 5", wide_combo(True), 5, 3),
            ("cap 1023", wide_combo(True), 1023, 1023),
            ("3 x 2^20 wrapping deltas", wide_combo(True)[:4] + (
                tp.StreamPlan("temp", "dec", scale=10, bits=12),),
             3 * BATCH, 3 * BATCH - 7)]
    for name, combo, hcap, hn in hand:
        w, bases = random_wire(dev, rng, combo, hcap)
        decode_vs_plain(w, combo, hcap, hn, bases, name)
        # the scratch is left zeroed: a second launch agrees too
        decode_vs_plain(w, combo, hcap, hn, bases, name + ", again")
    w, combo, bases, _ = head
    ms, call, src = kernel_ms(lambda: tp.decode_batch(w, combo, BATCH,
                                                      BATCH, bases), 50)
    plain = kernel_ms(lambda: tp.decode_batch_ref(w, combo, BATCH, BATCH,
                                                  bases), 5)[0]
    nbytes = w.numel() * 4 + BATCH * (4 + 4 + 1 + 4)
    b_ms, b_by = bound(nbytes, BATCH * len(combo) * 8)
    plan = tp.decode_plan(BATCH, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    results["wire_decode"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/decode.cu",
        replaces="hstream_tpu/engine/transport.py:197",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src,
        wire_bytes_per_event=w.numel() * 4 / BATCH,
        plan=plan._asdict())
    log(f"wire_decode: {len(cases) + len(hand)} wires bit-exact over "
        f"{sorted(encs)} and {len(hand)} hand-built random wires "
        f"({', '.join(h[0] for h in hand)}); {ms:.4f} ms (plain "
        f"{plain:.4f}, bound {b_ms:.4f}; grid {plan.blocks} blocks x "
        f"{plan.tiles} tiles)")


def awkward_inputs(dev, seed: int, n: int = BATCH):
    """A decoded batch of n records with the hard cases mixed in: records
    before the epoch (negative ts), late records, invalid rows, keys out
    of range, NaN, inf and -0.0 inputs, records over three windows."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, N_KEYS, n).astype(np.int32)
    key[::997] = 1024 + 5
    ts = (200_000 + np.sort(rng.integers(0, 30_000, n))).astype(np.int32)
    ts[::1009] = -rng.integers(1, 25_000, ts[::1009].shape[0])
    temp = (np.rint(rng.normal(20, 5, n) * 10).astype(np.float32)
            * np.float32(0.1))
    temp[::3001] = np.nan
    temp[1::4001] = np.inf
    temp[2::5003] = -0.0
    valid = rng.integers(0, 50, n) > 0

    def t(a):
        return torch.from_numpy(a).to(dev)

    return t(key), t(ts), t(valid), {"temp": t(temp)}


def copy_state(state):
    return {k: v.clone() for k, v in state.items()}


def int_bool_spec():
    """SUM, AVG, MIN, MAX and COUNT over an int32 column and COUNT and SUM
    over a bool one, each with a NULL mask of its own: the scatter's
    int32 and byte reads."""
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import TumblingWindow, lattice
    from hstream_tpu_torch.engine.expr import Col

    x, f = Col("ival"), Col("flag")
    aggs = (AggSpec(A.COUNT_ALL, "n"), AggSpec(A.SUM, "s", input=x),
            AggSpec(A.AVG, "a", input=x), AggSpec(A.MIN, "lo", input=x),
            AggSpec(A.MAX, "hi", input=x), AggSpec(A.COUNT, "c", input=x),
            AggSpec(A.COUNT, "cf", input=f), AggSpec(A.SUM, "sf", input=f))
    return lattice.LatticeSpec(n_keys=1024,
                               window=TumblingWindow(10_000, grace_ms=0),
                               aggs=aggs, track_touched=True)


def scatter_specs() -> dict:
    """Every lattice the port's window paths step, by name: configs 1 and
    2, the changelog query, phase 11's five aggregates, every scatter
    kind with a NULL mask (K2), int32 and bool inputs, and the join's
    inner lattice at the K = 2^19 that phase 8 grows it to (BASELINE
    config 5's COUNT(*))."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.sql import stream_codegen

    log_node = stream_codegen(LOG_SQL).select.node
    join_node = join_plan().node
    return {"config 1": make_spec(1), "config 2": make_spec(2),
            "changelog": changelog_plan()[2],
            "log": lattice.LatticeSpec(
                n_keys=1024, window=log_node.window,
                aggs=tuple(log_node.aggs), track_touched=False),
            "sketch kinds": k2_spec(), "int and bool": int_bool_spec(),
            "join inner": lattice.LatticeSpec(
                n_keys=1 << 19, window=join_node.window,
                aggs=tuple(join_node.aggs), track_touched=True)}


def _odd(t: torch.Tensor) -> torch.Tensor:
    """`t`'s values one element into a longer buffer: a column whose
    start is not 16-byte (a byte column's not 4-byte) aligned."""
    buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


def scatter_inputs(dev, spec, seed: int, n: int, two_slots: bool = False,
                   odd: bool = False):
    """A decoded batch for `spec`: awkward_inputs' hard cases (records
    before the epoch, late records, invalid rows, NaN, inf and -0.0,
    records over three windows) and subnormals, keys spread over [0, K) with some
    at K + 5 and some negative, and each aggregate's input column (the
    float32 `temp`; `ival` int32 with its extremes and values float32
    rounds; `flag` bool) and a 2 % NULL mask; with `two_slots`, the
    records' times cross one 10 s window end instead; with `odd`, the
    input columns and masks start one element into their buffers."""
    from hstream_tpu_torch.engine import lattice

    _, ts, valid, cols = awkward_inputs(dev, seed, n)
    rng = np.random.default_rng(seed + 7)
    k = rng.integers(0, spec.n_keys, n).astype(np.int32)
    k[::997] = spec.n_keys + 5
    k[5::1013] = -3
    key = torch.from_numpy(k).to(dev)
    if two_slots:
        ts = torch.from_numpy(
            (9_900 + np.sort(rng.integers(0, 200, n))).astype(np.int32)
        ).to(dev)
    irng = np.random.default_rng(seed + 11)
    ival = irng.integers(-50_000, 50_000, n).astype(np.int32)
    ival[::701] = np.iinfo(np.int32).min
    ival[1::709] = np.iinfo(np.int32).max
    ival[2::719] = (1 << 24) + 1
    ival[3::727] = -(1 << 24) - 3
    by_name = {"ival": torch.from_numpy(ival).to(dev),
               "flag": torch.from_numpy(irng.random(n) < 0.5).to(dev)}
    temp = cols["temp"].clone()    # with subnormals of both signs
    for i, v in enumerate((1e-45, -1e-45, 1e-40, -3e-39)):
        temp[11 + i::1019] = v
    out = {}
    for i, name in enumerate(lattice.agg_input_columns(spec)):
        if name is None:
            continue
        out[name] = by_name.get(name, temp)
        out[f"__null_a{i}"] = torch.from_numpy(rng.random(n) < 0.02).to(dev)
    if odd:
        out = {k: _odd(v) for k, v in out.items()}
    return key, ts, valid, out


def scatter_vs_plain(spec, state, wm, key, ts, valid, cols, mode, what):
    """The scatter kernel in the branch `mode` names and its plain
    version on the same inputs from `state`, each on its own copy:
    integer planes, MIN/MAX, HLL, bins, touched and slot_start exact,
    SUM/AVG within 2*n*2^-24*sum|x| per cell (n the cell's records and
    the prior value, sum|x| from the plain step over |x|); returns
    (largest SUM/AVG error, the plain version's state)."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.plan import AggKind

    a, b = copy_state(state), copy_state(state)
    before = lattice.scatter_step.launches
    lattice.scatter_step(spec, a, wm, key, ts, valid, cols, mode=mode)
    assert lattice.scatter_step.launches == before + 1
    lattice.scatter_step_ref(spec, b, wm, key, ts, valid, cols)
    absd = lattice.init_state(spec, key.device)
    lattice.scatter_step_ref(
        spec, absd, wm, key, ts, valid,
        {k: v.float().abs() if v.dtype in (torch.float32, torch.int32)
         else v for k, v in cols.items()})
    torch.cuda.synchronize()
    sums = {f"a{i}_{g.kind.value}" for i, g in enumerate(spec.aggs)
            if g.kind in (AggKind.SUM, AggKind.AVG)}
    n = b["count"].double() + 1
    err = 0.0
    for k in b:
        if k in sums:
            lim = 2 * n * U * (absd[k].double() * (1 + 1e-6)
                               + state[k].double().abs())
            d = (a[k].double() - b[k].double()).abs()
            bad = int((d > lim).sum())
            assert bad == 0, f"{what}: {k} beyond the order bound ({bad})"
            err = max(err, float(d.max()))
        else:
            assert same_bits(a[k], b[k], k), f"{what}: {k} differs"
    return err, b


def scatter_bound(spec, wm, key, ts, valid, cols) -> tuple[float, str]:
    """The least time for one scatter on the card: per record its key,
    ts and valid, each input column the aggregates read and each NULL
    mask read once,
    and per cell the records touch its count and private planes read
    and written once (HLL registers and quantile bins: one 1-byte or
    4-byte entry per distinct (cell, register or bin) the batch hits)."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.plan import AggKind

    st = lattice.init_state(spec, key.device)
    lattice.scatter_step_ref(spec, st, wm, key, ts, valid, cols)
    cells = st["count"].view(-1) > 0
    n_cells = int(cells.sum())
    per_rec, per_cell, extra = 4 + 4 + 1, 4, 0
    win = spec.window
    read = set()
    for i, (g, name) in enumerate(zip(spec.aggs,
                                      lattice.agg_input_columns(spec))):
        if name is None or g.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT):
            continue
        read.add(name)
        per_rec += 1 if f"__null_a{i}" in cols else 0
        if g.kind in (AggKind.COUNT, AggKind.SUM, AggKind.MIN, AggKind.MAX):
            per_cell += 4
        elif g.kind == AggKind.AVG:
            per_cell += 8
        else:
            plane = st[f"a{i}_{g.kind.value}"].view(st["count"].numel(),
                                                    -1)
            extra += int((plane[cells] != 0).sum()) * (
                1 if g.kind == AggKind.APPROX_COUNT_DISTINCT else 4)
    per_rec += sum(cols[name].element_size() for name in read)
    if spec.track_touched:
        per_cell += 1
    n = key.shape[0]
    nbytes = n * per_rec + 2 * (n_cells * per_cell + extra)
    return bound(nbytes, n * spec.windows_per_record * 40
                 if win is not None else n * 40)


# the first design's scatter (one thread per (record, window), every
# update a global atomic), device ms at these shapes on an H100 80GB HBM3
# at 700 W (PERF.md §6), printed beside this run's
SCATTER_RUN_K_MS = {"config 1": 0.0825, "config 2": 0.1311,
                    "changelog": 0.1657}


def check_scatter(dev, results, head):
    """B1c in both branches on every spec of scatter_specs(): configs 1
    and 2, the changelog query, phase 11's aggregates, K2 and the int32
    and bool inputs (each block-private with each of its two flushes,
    per block and per cluster, and forced global, on awkward batches and
    on a batch that crosses a window end, twice so the second lands on a
    filled state; the int32 and bool inputs also with their columns off
    the 16-byte loads' alignment), and the join's inner lattice at
    K = 2^19 (global) with a match-sized feed of 2^21 records; then
    configs 1 and 2 timed at the main path's shapes in both branches
    beside their bounds, the plain version and per-plane PyTorch
    calls."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import binding as kb
    from hstream_tpu_torch.engine.sketches import hll_update_indices

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = 0.0
    states = {}
    wm = 205_000               # the window [190 s, 200 s) is late
    branches = {}
    for si, (name, spec) in enumerate(scatter_specs().items()):
        n = 2 * BATCH if name == "join inner" else BATCH
        plan = lattice.scatter_plan(spec, n, sms)
        want_mode = (kb.SCATTER_GLOBAL if name == "join inner"
                     else kb.SCATTER_CLUSTER if spec.windows_per_record > 1
                     else kb.SCATTER_PRIVATE)
        assert plan.mode == want_mode, (name, plan)
        branches[name] = dict(mode=plan.mode, blocks=plan.blocks,
                              smem=lattice.scatter_smem_bytes(spec))
        # its own mode first, then (block-private) the other flush, which
        # the spec does not pick, and the global branch
        modes = [plan.mode]
        if plan.mode != kb.SCATTER_GLOBAL:
            modes += [kb.SCATTER_PRIVATE + kb.SCATTER_CLUSTER - plan.mode,
                      kb.SCATTER_GLOBAL]
        batches = [(False, False), (True, False)]
        if name == "int and bool":
            batches.append((False, True))
        for pi, mode in enumerate(modes):
            for two, odd in batches:
                key, ts, valid, cols = scatter_inputs(dev, spec, 20 + si,
                                                      n, two, odd)
                state = lattice.init_state(spec, dev)
                for rnd in range(2):
                    e, state = scatter_vs_plain(
                        spec, state, -1 if two else wm, key, ts, valid, cols,
                        mode,
                        f"scatter {name} mode {mode} "
                        f"{'two slots' if two else 'awkward'}"
                        f"{' unaligned' if odd else ''} round {rnd}")
                    err = max(err, e)
                assert int(state["count"].sum()) > 0, name
                if name in ("config 1", "config 2") and pi == 0 and not two:
                    states[int(name[-1])] = state
    # config 1 timed at the main path's shapes: the headline batch
    spec = make_spec(1)
    _, _, _, (key, ts, valid, cols) = head
    wm = -1
    st = lattice.init_state(spec, dev)
    ms, call, src = kernel_ms(lambda: lattice.scatter_step(
        spec, st, wm, key, ts, valid, cols), 30)
    ms_g = kernel_ms(lambda: lattice.scatter_step(
        spec, st, wm, key, ts, valid, cols, mode=kb.SCATTER_GLOBAL), 30)[0]
    plain = kernel_ms(lambda: lattice.scatter_step_ref(
        spec, st, wm, key, ts, valid, cols), 3)[0]
    # one PyTorch call per plane on precomputed indices: the library's
    # own index_put_(accumulate) / scatter_reduce_
    slot = torch.remainder(torch.div(ts, 10_000, rounding_mode="floor"),
                           3).long()
    cell = key.long() * 3 + slot
    start = (ts - torch.remainder(ts, 10_000))
    v = cols["temp"]
    reg, rank = hll_update_indices(v, spec.hll)
    hidx = cell * 1024 + reg
    rank8 = rank.to(torch.int8)
    ones = torch.ones_like(key)
    lib = lattice.init_state(spec, dev)

    def library():
        lib["count"].view(-1).index_put_((cell,), ones, accumulate=True)
        lib["slot_start"].scatter_reduce_(0, slot, start, "amax")
        lib["a1_sum"].view(-1).index_put_((cell,), v, accumulate=True)
        lib["a2_approx_count_distinct"].view(-1).scatter_reduce_(
            0, hidx, rank8, "amax")

    lib_ms = kernel_ms(library, 30)[0]
    b_ms, b_by = scatter_bound(spec, wm, key, ts, valid, cols)
    # config 2's lattice on the same records, at its epoch offset (its
    # epoch sits 110 s before the first record): six windows each
    spec2 = make_spec(2)
    st2 = lattice.init_state(spec2, dev)
    ts2 = ts + 100_000
    lattice.scatter_step(spec2, st2, wm, key, ts2, valid, cols)
    assert int(st2["count"].sum()) == 6 * BATCH
    ms2 = kernel_ms(lambda: lattice.scatter_step(
        spec2, st2, wm, key, ts2, valid, cols), 30)[0]
    ms2_g = kernel_ms(lambda: lattice.scatter_step(
        spec2, st2, wm, key, ts2, valid, cols, mode=kb.SCATTER_GLOBAL),
        30)[0]
    b2_ms, b2_by = scatter_bound(spec2, wm, key, ts2, valid, cols)
    # the join's inner lattice (global branch) on a match-sized feed
    specj = scatter_specs()["join inner"]
    kj, tj, vj, cj = scatter_inputs(dev, specj, 30, 2 * BATCH, True)
    stj = lattice.init_state(specj, dev)
    msj = kernel_ms(lambda: lattice.scatter_step(specj, stj, -1, kj, tj, vj,
                                                 cj), 30)[0]
    results["scatter_aggregate"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/scatter.cu",
        replaces="hstream_tpu/engine/lattice.py:138",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, call_ms=call, ms_source=src,
        ms_global=ms_g, ms_config2=ms2, ms_config2_global=ms2_g,
        bound_ms_config2=b2_ms, bound_by_config2=b2_by,
        ms_join_inner=msj, branches=branches)
    old = SCATTER_RUN_K_MS
    log(f"scatter_aggregate: {len(branches)} specs (branches "
        f"{json.dumps(branches)}) exact in both branches, SUM/AVG within "
        f"the order bound (max err {err:.3g}); config 1 {ms:.4f} ms "
        f"(first design {old['config 1']}, global branch {ms_g:.4f}, plain "
        f"{plain:.4f}, library {lib_ms:.4f}, bound {b_ms:.4f} by {b_by}); "
        f"config 2 {ms2:.4f} ms (first design {old['config 2']}, "
        f"global branch {ms2_g:.4f}, bound {b2_ms:.4f} by {b2_by}); the "
        f"join's inner "
        f"lattice (K = 2^19, global) on 2^21 records {msj:.4f} ms")
    return states


def random_lattice_state(spec, dev, seed: int) -> dict:
    """A lattice state with every plane drawn at random within what a
    step leaves: counts 0 to 40 (a third 0), touched flags, slot starts
    (some empty), SUM/AVG sums and AVG counts, MIN/MAX values with their
    +-inf identities and -0.0, COUNT(col) counts, HLL ranks up to 33 - p,
    sparse histograms (some cells empty, some with large counts) and
    TOPK values with -inf among them."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.plan import AggKind as A

    rng = np.random.default_rng(seed)
    st = {k: v.cpu().numpy().copy()
          for k, v in lattice.init_state(spec, "cpu").items()}
    shape = st["count"].shape
    st["count"][:] = np.where(rng.random(shape) < 0.33, 0,
                              rng.integers(1, 40, shape))
    st["touched"][:] = rng.random(shape) < 0.5
    st["slot_start"][:] = np.where(
        rng.random(spec.n_slots) < 0.2, lattice.EMPTY_START,
        rng.integers(-(1 << 30), 1 << 30, spec.n_slots))
    for i, agg in enumerate(spec.aggs):
        if agg.kind == A.COUNT_ALL:
            continue
        p = st[lattice._plane_name(i, agg)]
        if agg.kind in (A.SUM, A.AVG):
            p[:] = rng.normal(0, 1e4, p.shape)
            if agg.kind == A.AVG:
                n = st[lattice._plane_name(i, agg) + "_n"]
                n[:] = np.where(rng.random(shape) < 0.2, 0,
                                rng.integers(1, 40, shape))
        elif agg.kind in (A.MIN, A.MAX):
            p[:] = rng.normal(0, 100, p.shape)
            p[rng.random(p.shape) < 0.2] = np.inf if agg.kind == A.MIN \
                else -np.inf
            p[rng.random(p.shape) < 0.05] = -0.0
        elif agg.kind == A.COUNT:
            p[:] = rng.integers(0, 40, p.shape)
        elif agg.kind == A.APPROX_COUNT_DISTINCT:
            hit = rng.random(p.shape) < rng.random(shape)[..., None]
            p[:] = np.where(hit, rng.integers(
                1, spec.hll.max_rank + 1, p.shape), 0)
        elif agg.kind == A.APPROX_QUANTILE:
            hit = rng.random(p.shape) < 0.03
            p[:] = np.where(hit, rng.integers(1, 9, p.shape), 0)
            p[rng.random(shape) < 0.1] = 0                # empty cells
            big = rng.random(shape) < 0.02   # totals past 2^24
            p[big, rng.integers(0, p.shape[-1])] = 1 << 25
        else:   # TOPK, TOPK_DISTINCT
            p[:] = -np.sort(-rng.normal(0, 100, p.shape), axis=-1)
            p[rng.random(p.shape) < 0.3] = -np.inf
    return {k: torch.from_numpy(v).to(dev) for k, v in st.items()}


def close_specs() -> dict:
    """The close's extra lattices: every aggregate kind (sketch kinds,
    TOPK, AVG, quantile planes) at HLL p of 4, 10 and 14 and at 100 and
    1024 quantile bins over 1000 keys (not a multiple of a block's keys),
    scalars and TOPK alone over 1003 keys (a thread a key), and a 24 h
    grace (8643 slots) over 13 keys for a slot vector of 8,192."""
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import TumblingWindow, lattice
    from hstream_tpu_torch.engine.expr import Col
    from hstream_tpu_torch.engine.sketches import HLLConfig, QuantileConfig

    x = Col("temp")
    win = TumblingWindow(10_000, grace_ms=30_000)
    out = {f"every kind, p {p}": lattice.LatticeSpec(
        n_keys=1000, window=win, aggs=k2_spec().aggs, hll=HLLConfig(p),
        track_touched=True) for p in (4, 10, 14)}
    for bins in (100, 1024):   # rounds cut short; rounds read twice
        out[f"every kind, {bins} bins"] = lattice.LatticeSpec(
            n_keys=1000, window=win, aggs=k2_spec().aggs,
            qcfg=QuantileConfig(n_bins=bins), track_touched=True)
    out["scalars and TOPK"] = lattice.LatticeSpec(
        n_keys=1003, window=win,
        aggs=(AggSpec(A.AVG, "a", input=x), AggSpec(A.MIN, "lo", input=x),
              AggSpec(A.TOPK, "t", input=x, k=5),
              AggSpec(A.COUNT, "c", input=x)), track_touched=True)
    out["8192 slots"] = lattice.LatticeSpec(
        n_keys=13, window=TumblingWindow(10_000, grace_ms=86_400_000),
        aggs=(AggSpec(A.COUNT_ALL, "n"), AggSpec(A.SUM, "s", input=x),
              AggSpec(A.APPROX_COUNT_DISTINCT, "u", input=x),
              AggSpec(A.APPROX_QUANTILE, "q", input=x, quantile=0.5),
              AggSpec(A.TOPK, "t", input=x, k=3),
              AggSpec(A.AVG, "a", input=x)), track_touched=True)
    return out


def close_vs_plain(spec, state, slots, mode, what: str) -> None:
    """One close of `slots` (padded) against the plain extract and reset,
    packed rows and every plane exact."""
    from hstream_tpu_torch.engine import lattice

    a, b = copy_state(state), copy_state(state)
    got = lattice.close_slots(spec, a, slots, mode)
    st = torch.from_numpy(slots).to(state["count"].device)
    want = None
    if mode != lattice.CLOSE_RESET:
        want = lattice.extract_slots_ref(spec, b, st)
    if mode != lattice.CLOSE_EXTRACT:
        lattice.reset_slots_ref(spec, b, st)
    torch.cuda.synchronize()
    if want is not None:
        assert torch.equal(got, want), f"close {what} {mode}: rows"
    for k in b:
        assert torch.equal(a[k], b[k]), f"close {what} {mode}: {k}"


def check_close(dev, results, states):
    from hstream_tpu_torch.engine import lattice

    err = 0.0
    cases = [(1, [0, 2], lattice.CLOSE_EXTRACT_RESET),
             (1, [1, 2, 0], lattice.CLOSE_EXTRACT_RESET),
             (1, [0, 1, 2], lattice.CLOSE_EXTRACT),
             (1, [1], lattice.CLOSE_RESET),
             (2, [3, 0, 7, 5, 1], lattice.CLOSE_EXTRACT_RESET),
             (2, list(range(8)), lattice.CLOSE_EXTRACT),
             (2, [6, 2], lattice.CLOSE_RESET)]
    for cfg, sl, mode in cases:
        close_vs_plain(make_spec(cfg), states[cfg], lattice.pad_slots(sl),
                       mode, f"{cfg} {sl}")
    # every kind, HLL p 4 / 10 / 14, K off the tile, a thread a key, one
    # slot and 8,192: each mode, twice in a row (the tile counters of an
    # extract-and-reset close must be back at 0 for the next)
    rng = np.random.default_rng(47)
    extra = 0
    for name, spec in close_specs().items():
        state = random_lattice_state(spec, dev, 48 + extra)
        W = spec.n_slots
        vecs = [np.array([int(rng.integers(0, W))], np.int32),
                rng.permutation(W)[:min(W, 8000)].astype(np.int32)]
        for sl in vecs:
            slots = lattice.pad_slots(sl)
            for mode in (lattice.CLOSE_EXTRACT_RESET, lattice.CLOSE_EXTRACT,
                         lattice.CLOSE_RESET, lattice.CLOSE_EXTRACT_RESET):
                close_vs_plain(spec, state, slots, mode,
                               f"{name} P={len(slots)}")
                extra += 1
        lanes = {m: lattice.close_plan(spec, m) for m in range(3)}
        log(f"fused_close {name}: K={spec.n_keys}, W={W}, lanes {lanes}, "
            f"P 1 and {len(lattice.pad_slots(vecs[1]))}: exact")
    # time at the main path's shapes: one due window of config 1
    spec = make_spec(1)
    st = copy_state(states[1])
    slots = lattice.pad_slots([0])
    slots_t = torch.from_numpy(slots).to(dev)
    ms, call, src = kernel_ms(lambda: lattice.close_slots(spec, st, slots),
                              50)

    def plain_close():
        lattice.extract_slots_ref(spec, st, slots_t)
        lattice.reset_slots_ref(spec, st, slots_t)

    plain = kernel_ms(plain_close, 5)[0]
    rows = 2 + len(spec.aggs)
    cells = spec.n_keys * (4 + 4 + 1024)      # one slot: count, sum, HLL
    b_ms, b_by = bound(2 * cells + rows * spec.n_keys * 4,
                       spec.n_keys * 1024 * 4)
    # mode 1 alone (the extract-only peek, B3): reads, writes the rows
    ms1, call1, src1 = kernel_ms(lambda: lattice.close_slots(
        spec, st, slots, lattice.CLOSE_EXTRACT), 50)
    plain1 = kernel_ms(lambda: lattice.extract_slots_ref(
        spec, st, slots_t), 5)[0]
    b1_ms, b1_by = bound(cells + rows * spec.n_keys * 4,
                         spec.n_keys * 1024 * 4)
    results["fused_close"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/close.cu",
        replaces="hstream_tpu/engine/lattice.py:624",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src,
        extract_only_ms=ms1, extract_only_call_ms=call1,
        extract_only_plain_ms=plain1, extract_only_bound_ms=b1_ms,
        extract_only_bound_by=b1_by)
    # B3, the extract-only close (a peek), in the kernels line of its own:
    # the close wrapper's extract-only count, launched by the servers' pull
    # queries (phases 13 and 16)
    results["extract_close"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/close.cu",
        replaces="hstream_tpu/engine/lattice.py:642",
        paths=("server", "replicated"),
        max_abs_err=err, ms=ms1, plain_ms=plain1, bound_ms=b1_ms,
        bound_by=b1_by, library_ms=None, call_ms=call1, ms_source=src1)
    log(f"fused_close: {len(cases) + extra} cases (3 modes) bit-exact; "
        f"{ms:.4f} ms "
        f"(plain {plain:.4f}, bound {b_ms:.4f}); extract-only {ms1:.4f} ms "
        f"(plain {plain1:.4f}, bound {b1_ms:.5f})")


def check_rebase(dev, results):
    """B4: exact at the window lattices' slot counts and off the block's
    64; timed beside an empty kernel launched on the same stream, the
    floor no launch can beat."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import binding as kb

    ss = torch.tensor([lattice.EMPTY_START, 90_000, 30_000,
                       lattice.EMPTY_START, 60_000], dtype=torch.int32,
                      device=dev)
    a, b = {"slot_start": ss.clone()}, {"slot_start": ss.clone()}
    lattice.rebase(a, 30_000)
    lattice.rebase_ref(b, 30_000)
    torch.cuda.synchronize()
    assert torch.equal(a["slot_start"], b["slot_start"]), "rebase differs"
    # one warp a block, two slots a lane: slot counts off the block's 64
    # and off its lanes' 32
    rng = np.random.default_rng(41)
    for w in (1, 8, 31, 32, 33, 63, 64, 65, 8641):
        v = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, w)
                             .astype(np.int32)).to(dev)
        v[::3] = lattice.EMPTY_START
        a, b = {"slot_start": v.clone()}, {"slot_start": v.clone()}
        lattice.rebase(a, 123_457)
        lattice.rebase_ref(b, 123_457)
        torch.cuda.synchronize()
        assert torch.equal(a["slot_start"], b["slot_start"]), \
            f"rebase differs at W = {w}"
    st = {"slot_start": ss[:3].clone()}     # W = 3, the headline lattice
    st8 = {"slot_start": torch.cat([ss, ss[:3]]).clone()}   # W = 8, HOP
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the floor: an empty kernel of the same shape on the same stream,
    # timed between the rebase's two timings
    ms, call, src = kernel_ms(lambda: lattice.rebase(st, 0), 200)
    empty_call = cuda_time_ms(lambda: kb.check(kb.lib().hs_empty(stream),
                                               "empty"), 200)
    empty = None   # the profiler now and then records none of its events
    for _ in range(3):
        empty = kernel_only_ms(lambda: kb.check(
            kb.lib().hs_empty(stream), "empty"), 200, "empty_kernel")
        if empty:
            break
    ms8 = kernel_ms(lambda: lattice.rebase(st8, 0), 200)[0]
    plain = kernel_ms(lambda: lattice.rebase_ref(st, 0), 200)[0]
    b_ms, b_by = bound(2 * 3 * 4, 3)
    results["rebase"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/rebase.cu",
        replaces="hstream_tpu/engine/lattice.py:1571",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src,
        ms_w8=ms8, empty_kernel_ms=empty, empty_kernel_call_ms=empty_call,
        over_floor=(ms / empty - 1.0) if empty and src == "profiler"
        else None)
    floor = (f"an empty kernel {empty:.5f}, {100 * (ms / empty - 1):+.1f} %"
             if empty and src == "profiler" else
             "the profiler lost the empty kernel's or the rebase's events")
    log(f"rebase: exact at W = 3, 5, 1, 8, 31-33, 63-65, 8641; {ms:.5f} "
        f"ms at W = 3, {ms8:.5f} at W = 8 ({floor}; plain {plain:.4f}, bound "
        f"{b_ms:.2e} by {b_by})")


# ---- phases 4-5: the main path ----------------------------------------------

def check_rows(cfg, spec, rows, per_key, dev, ref_of=None) -> int:
    """Every emitted row against the numpy reference of its window
    (`ref_of(start)`; the main path's batches by default)."""
    from hstream_tpu_torch.engine.sketches import hll_estimate

    size = spec.window.size_ms
    by_win: dict[int, list] = {}
    for r in rows:
        by_win.setdefault(r["winStart"], []).append(r)
    assert len(by_win) >= 2, f"config {cfg}: {len(by_win)} windows closed"
    for start, rs in by_win.items():
        ref = (window_reference(per_key, start, size) if ref_of is None
               else ref_of(start))
        keys = np.array([int(r["device"][1:]) for r in rs])
        assert len(rs) == N_KEYS and len(set(keys)) == N_KEYS, start
        assert all(r["winEnd"] == start + size for r in rs)
        n = ref["count"][keys]
        lim = 2 * n * U * ref["abs"][keys]
        if cfg == 1:
            cnt = np.array([r["cnt"] for r in rs])
            assert (cnt == n).all(), f"window {start}: counts differ"
            total = np.array([r["total"] for r in rs])
            assert (np.abs(total - ref["sum"][keys]) <= lim).all(), \
                f"window {start}: SUM beyond the bound"
            regs = torch.from_numpy(ref["regs"][keys][:, None, :]).to(dev)
            est = hll_estimate(regs, spec.hll)[:, 0].cpu().numpy()
            uniq = np.array([r["uniq"] for r in rs])
            assert (uniq == np.rint(est)).all(), \
                f"window {start}: HLL estimate differs"
        else:
            avg = np.array([r["avg"] for r in rs])
            want = ref["sum"][keys] / n
            assert (np.abs(avg - want) <= lim / n + 2 * U * np.abs(want)
                    ).all(), f"window {start}: AVG beyond the bound"
            lo = np.array([r["lo"] for r in rs])
            hi = np.array([r["hi"] for r in rs])
            assert (lo == ref["min"][keys]).all(), f"{start}: MIN differs"
            assert (hi == ref["max"][keys]).all(), f"{start}: MAX differs"
    return len(by_win)


def main_path(cfg: int, dev) -> dict:
    """One configuration's main path through the port's entry points, on
    the default device (the card)."""
    from hstream_tpu_torch.engine import (
        AggregateNode,
        ColumnType,
        IngestPipeline,
        QueryExecutor,
        Schema,
        SourceNode,
    )
    from hstream_tpu_torch.engine import codec_native
    from hstream_tpu_torch.engine.expr import Col

    spec = make_spec(cfg)
    schema = Schema.of(device=ColumnType.STRING, temp=ColumnType.FLOAT)
    node = AggregateNode(child=SourceNode("sensors", schema),
                         group_keys=[Col("device")], window=spec.window,
                         aggs=list(spec.aggs))
    ex = QueryExecutor(node, schema, emit_changes=False, initial_keys=1024,
                       batch_capacity=BATCH)
    assert ex.device == dev, ex.device
    ex.defer_close_decode = True
    for k in range(N_KEYS):
        ex.key_id_for((f"d{k}",))
    src = Batches(seed=cfg)
    per_key = src.per_key()
    codec_native.load()          # the host codec builds outside the timing
    pipe = IngestPipeline(ex, depth=4, workers=2)
    zero_counts()
    rows: list = []
    try:
        t0 = time.perf_counter()
        for b in range(MAIN_BATCHES):
            kids, ts, temps = src.get(b)
            rows.extend(pipe.submit(kids, ts, {"temp": temps}))
        rows.extend(pipe.flush())
        rows.extend(ex.drain_closed())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages = pipe.stats()  # host busy-seconds per stage (host clock)
    finally:
        pipe.close()
    stats = dict(ex.close_stats)
    n_windows = check_rows(cfg, spec, rows, per_key, dev)
    assert stats["close_cycles"] == stats["close_dispatches"] >= 2, stats
    assert stats["close_fetches"] <= stats["close_cycles"], stats
    # close latency: a small batch crosses the next boundary; ONE close
    # launch and ONE fetch per cycle. The first sample rebases the epoch.
    ex.defer_close_decode = False
    ex.rebase_threshold = 1 << 15
    epoch0 = ex.epoch
    adv = spec.window.advance_ms
    b, latency = MAIN_BATCHES, []
    for _ in range(CLOSE_SAMPLES):
        kids, ts, temps = src.get(b)
        ex.process_columnar(kids, ts, {"temp": temps})
        boundary = (int(ts.max()) // adv + 1) * adv
        n = 4096
        before = dict(ex.close_stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.process_columnar(
            np.arange(n, dtype=np.int32) % N_KEYS,
            np.full(n, boundary + 1, np.int64),
            {"temp": np.full(n, np.float32(21.5))})
        latency.append((time.perf_counter() - t0) * 1e3)
        delta = {k: ex.close_stats[k] - before[k] for k in before}
        assert delta == {"close_cycles": 1, "close_dispatches": 1,
                         "close_fetches": 1}, delta
        assert len(out) == N_KEYS and all(r["winEnd"] == boundary
                                          for r in out)
        b = (boundary - BASE_TS) // STREAM_MS_PER_BATCH + 1
    assert ex.epoch != epoch0, "the lowered threshold did not rebase"
    counts = launch_counts()
    steps = MAIN_BATCHES + 2 * CLOSE_SAMPLES
    assert counts["wire_decode"] == counts["scatter_aggregate"] == steps, \
        counts
    assert counts["fused_close"] == ex.close_stats["close_dispatches"], \
        (counts, ex.close_stats)
    assert all(counts[k] > 0 for k in ("wire_decode", "scatter_aggregate",
                                       "fused_close", "rebase")), counts
    # no WHERE, computed input, TOPK or changelog on this path: still two
    # launches per batch
    assert counts["expression"] == counts["topk_fold"] == \
        counts["touched_extract"] == counts["reset_close"] == 0, counts
    assert all(counts[k] == 0 for k in counts if k.startswith("session")), \
        counts
    eps = MAIN_BATCHES * BATCH / wall
    return dict(config=cfg, events_per_sec=eps, wall_s=wall,
                windows_checked=n_windows, rows=len(rows),
                close_stats=ex.close_stats, launches=counts,
                close_latency_ms=latency,
                close_latency_ms_median=float(np.median(latency)),
                transfer_stats=ex.transfer_stats, pipeline_stages=stages)


# ---- phase 5b: a query past the old caps --------------------------------------

WIDE_KEYS = 64
WIDE_BATCH = 1 << 16
WIDE_BATCHES = 10            # 2 s of stream each: two windows close
WIDE_MS = 2_000
WIDE_COLS = tuple(f"c{k}" for k in range(20))


def wide_plan():
    """(node, schema) of a window query the port once refused on the
    card: 24 aggregates over 20 columns with a WHERE, its computed
    inputs a chain of 40 additions, a nest of 20 subtractions and a
    balanced sum of 64 products (their register forms, with the WHERE's
    and the others', take two argument blocks of the expression
    kernel); values are integers 0 to 3, so every sum is exact in any
    order."""
    from hstream_tpu_torch.engine import (
        AggKind as A, AggregateNode, AggSpec, ColumnType, FilterNode,
        Schema, SourceNode, TumblingWindow)
    from hstream_tpu_torch.engine.expr import BinOp, Col, Lit

    c = [Col(n) for n in WIDE_COLS]
    chain = c[15]
    for k in range(40):
        chain = BinOp("+", chain, c[(16 + k) % 20])
    nest = c[16]
    for k in range(20):
        nest = BinOp("-", c[17 if k % 2 else 16], nest)
    level = [BinOp("*", c[k % 20], c[(k + 7) % 20]) for k in range(64)]
    while len(level) > 1:
        level = [BinOp("+", level[k], level[k + 1])
                 for k in range(0, len(level), 2)]
    kinds = (A.SUM, A.MIN, A.MAX, A.AVG, A.COUNT)
    aggs = [AggSpec(A.COUNT_ALL, "cnt")]
    aggs += [AggSpec(kinds[k % 5], f"a{k}", input=c[k]) for k in range(15)]
    aggs += [AggSpec(A.SUM, "chain", input=chain),
             AggSpec(A.SUM, "nest", input=nest),
             AggSpec(A.SUM, "prod", input=level[0]),
             AggSpec(A.APPROX_COUNT_DISTINCT, "dc", input=c[2]),
             AggSpec(A.APPROX_QUANTILE, "q50", input=c[3], quantile=0.5),
             AggSpec(A.SUM, "mix", input=BinOp("+", BinOp("*", c[0],
                                                           Lit(2.0)), c[1])),
             AggSpec(A.MAX, "dmax", input=BinOp("-", c[4], c[5])),
             AggSpec(A.MIN, "pmin", input=BinOp("*", c[6], c[7]))]
    schema = Schema.of(device=ColumnType.STRING,
                       **{n: ColumnType.FLOAT for n in WIDE_COLS})
    where = BinOp("AND", BinOp(">", c[19], Lit(0.0)),
                  BinOp("<", c[18], Lit(3.0)))
    node = AggregateNode(child=FilterNode(SourceNode("wide", schema), where),
                         group_keys=[Col("device")],
                         window=TumblingWindow(10_000, grace_ms=0),
                         aggs=aggs)
    return node, schema


def _np_eval(e, cols: dict) -> np.ndarray:
    """numpy float64 of an expression over integer columns (exact)."""
    from hstream_tpu_torch.engine.expr import BinOp, Col

    if isinstance(e, Col):
        return cols[e.name].astype(np.float64)
    if isinstance(e, BinOp):
        a, b = _np_eval(e.left, cols), _np_eval(e.right, cols)
        return {"+": a + b, "-": a - b, "*": a * b}[e.op]
    return np.float64(e.value)


def wide_reference(node, batches, qcfg, hll_p: int) -> dict:
    """{(key, window start): {name: value}} of every window the batches
    fill, in numpy: exact sums, MIN/MAX, counts, AVG as float32 sum / n,
    the HLL registers' estimate and the quantile histogram's bin."""
    from hstream_tpu_torch.engine.plan import AggKind as A

    keys = np.concatenate([b[0] for b in batches]).astype(np.int64)
    ts = np.concatenate([b[1] for b in batches])
    cols = {n: np.concatenate([b[2][n] for b in batches])
            for n in WIDE_COLS}
    keep = (cols["c19"] > 0) & (cols["c18"] < 3)
    keys, ts = keys[keep], ts[keep]
    cols = {n: v[keep] for n, v in cols.items()}
    start = (ts // 10_000) * 10_000
    cell = keys * 4096 + (start - BASE_TS) // 10_000
    uniq, inv = np.unique(cell, return_inverse=True)
    n = np.bincount(inv)
    out = {}
    per = {}
    for agg in node.aggs:
        if agg.kind == A.COUNT_ALL:
            per[agg.out_name] = n.astype(np.float64)
            continue
        v = _np_eval(agg.input, cols)
        if agg.kind in (A.SUM, A.AVG):
            tot = np.bincount(inv, weights=v)
            per[agg.out_name] = tot if agg.kind == A.SUM else (
                tot.astype(np.float32) / n.astype(np.float32))
        elif agg.kind == A.COUNT:
            per[agg.out_name] = n.astype(np.float64)
        elif agg.kind in (A.MIN, A.MAX):
            m = np.full(len(uniq), np.inf if agg.kind == A.MIN else -np.inf)
            (np.minimum if agg.kind == A.MIN else np.maximum).at(m, inv, v)
            per[agg.out_name] = m
        elif agg.kind == A.APPROX_COUNT_DISTINCT:
            regs = np.zeros((len(uniq), 1 << hll_p), np.int8)
            reg, rank = np_hll_indices(v.astype(np.float32), hll_p)
            np.maximum.at(regs, (inv, reg), rank.astype(np.int8))
            per[agg.out_name] = regs
        else:
            b, edge = np_quantile_bins(v.astype(np.float32), qcfg)
            assert not edge.any(), "a value at a bin edge"
            hist = np.zeros((len(uniq), qcfg.n_bins), np.int64)
            np.add.at(hist, (inv, b), 1)
            per[agg.out_name] = np_quantile_estimate(
                hist, agg.quantile, qcfg)[0]
    for j, c in enumerate(uniq):
        out[(int(c // 4096), BASE_TS + int(c % 4096) * 10_000)] = {
            k: v[j] for k, v in per.items()}
    return out


def wide_path(dev) -> dict:
    """Phase 5b: wide_plan's query through IngestPipeline on the card,
    10 batches of 2^16 records over 64 keys (2 s of stream each) and a
    closer; every row of the two closed windows against numpy; per
    batch one decode, one scatter and the expression's blocks."""
    from hstream_tpu_torch.engine import IngestPipeline, QueryExecutor
    from hstream_tpu_torch.engine import expr as ex
    from hstream_tpu_torch.engine.sketches import hll_estimate

    node, schema = wide_plan()
    qx = QueryExecutor(node, schema, emit_changes=False,
                       initial_keys=WIDE_KEYS, batch_capacity=WIDE_BATCH)
    assert qx.device == dev and len(qx.spec.aggs) == 24
    for k in range(WIDE_KEYS):
        qx.key_id_for((f"d{k}",))
    plan = ex.launch_plan(qx._progs)
    n_ins = sum(len(ex.lower(p).ins) for b in plan.blocks
                for p, _ in b.progs)
    assert len(plan.blocks) >= 2 and n_ins > 256, (len(plan.blocks), n_ins)
    rng = np.random.default_rng(55)
    batches = []
    for b in range(WIDE_BATCHES):
        kids = rng.integers(0, WIDE_KEYS, WIDE_BATCH).astype(np.int32)
        ts = BASE_TS + b * WIDE_MS + np.sort(
            rng.integers(0, WIDE_MS, WIDE_BATCH)).astype(np.int64)
        cols = {n: rng.integers(0, 4, WIDE_BATCH).astype(np.float32)
                for n in WIDE_COLS}
        batches.append((kids, ts, cols))
    pipe = IngestPipeline(qx, depth=4, workers=2)
    zero_counts()
    rows: list = []
    try:
        t0 = time.perf_counter()
        for kids, ts, cols in batches:
            rows.extend(pipe.submit(kids, ts, cols))
        closer = (np.zeros(1, np.int32),
                  np.array([BASE_TS + WIDE_BATCHES * WIDE_MS], np.int64),
                  {n: np.float32([1.0 if n == "c19" else 0.0])
                   for n in WIDE_COLS})
        rows.extend(pipe.submit(*closer))
        rows.extend(pipe.flush())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipe.close()
    counts = launch_counts()
    steps = WIDE_BATCHES + 1
    assert counts["wire_decode"] == counts["scatter_aggregate"] == steps, \
        counts
    assert counts["expression"] == steps * len(plan.blocks), counts
    assert counts["fused_close"] == qx.close_stats["close_dispatches"] >= 1
    ref = wide_reference(node, batches, qx.spec.qcfg, qx.spec.hll.precision)
    got = {(int(r["device"][1:]), r["winStart"]): r for r in rows}
    closed = {k for k in ref if k[1] + 10_000 <= BASE_TS
              + WIDE_BATCHES * WIDE_MS}
    assert set(got) == closed, (len(got), len(closed))
    for key in closed:
        r, w = got[key], ref[key]
        for name, want in w.items():
            if name == "dc":
                regs = torch.from_numpy(want[None, None, :]).to(dev)
                want = float(torch.round(hll_estimate(regs, qx.spec.hll))
                             [0, 0])
            if name == "q50":   # the card's expf against numpy's
                assert abs(r[name] - float(want)) <= 2e-6 * abs(want), \
                    (key, name, r[name], want)
            else:
                assert float(r[name]) == float(want), \
                    (key, name, r[name], want)
    return dict(config="wide (24 aggregates, 20 columns)",
                events_per_sec=steps * WIDE_BATCH / wall, wall_s=wall,
                windows_checked=len({k[1] for k in closed}),
                rows=len(rows), launches=counts,
                expression_blocks=len(plan.blocks),
                expression_instructions=n_ins,
                close_stats=dict(qx.close_stats))


# ---- this slice's kernels: the changelog query's ----------------------------

NULL_RATE = 0.01
TOPK_K = 3


def changelog_plan():
    """(node, schema, spec, progs) of the changelog path's query:
    SELECT device, COUNT(temp), SUM(temp * 1.8 + 32),
    APPROX_QUANTILE(temp, 0.99), TOPK(temp, 3), TOPK_DISTINCT(temp, 3)
    FROM sensors WHERE temp > 15.0 GROUP BY device, TUMBLE(10s)
    EMIT CHANGES."""
    from hstream_tpu_torch.engine import (
        AggKind as A,
        AggregateNode,
        AggSpec,
        ColumnType,
        FilterNode,
        Schema,
        SourceNode,
        TumblingWindow,
    )
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.expr import BinOp, Col, Lit

    temp = Col("temp")
    schema = Schema.of(device=ColumnType.STRING, temp=ColumnType.FLOAT)
    where = BinOp(">", temp, Lit(15.0))
    aggs = [AggSpec(A.COUNT, "c", input=temp),
            AggSpec(A.SUM, "s", input=BinOp(
                "+", BinOp("*", temp, Lit(1.8)), Lit(32))),
            AggSpec(A.APPROX_QUANTILE, "q", input=temp, quantile=0.99),
            AggSpec(A.TOPK, "t", input=temp, k=TOPK_K),
            AggSpec(A.TOPK_DISTINCT, "td", input=temp, k=TOPK_K)]
    node = AggregateNode(
        child=FilterNode(SourceNode("sensors", schema), where),
        group_keys=[Col("device")], window=TumblingWindow(10_000, grace_ms=0),
        aggs=aggs)
    spec = lattice.LatticeSpec(n_keys=1024, window=node.window,
                               aggs=tuple(aggs), track_touched=True)
    return node, schema, spec, lattice.step_programs(spec, schema, where)


def changelog_batch(dev):
    """The changelog path's step input: one headline batch with a 1 %
    NULL mask on temp, wire-encoded as the executor encodes it (the
    filter column's NULLs clear valid; every aggregate reads temp, so
    each gets the mask as its __null_a{i} stream), decoded by the plain
    version."""
    from hstream_tpu_torch.engine import transport as tp

    _, _, spec, progs = changelog_plan()
    rng = np.random.default_rng(5)
    kids = rng.integers(0, N_KEYS, BATCH).astype(np.int32)
    ts = 10_000 + (np.arange(BATCH, dtype=np.int64) * 200) // BATCH
    temps = (np.rint(rng.normal(20, 5, BATCH) * 10).astype(np.float32)
             * np.float32(0.1))
    nulls = rng.random(BATCH) < NULL_RATE
    combo, bases, words = tp.BitpackTransport().encode(
        BATCH, BATCH, kids, ts, {"temp": temps}, (("temp", "f32"),),
        valid=~nulls,
        null_streams={f"__null_a{i}": nulls for i in range(len(spec.aggs))})
    w = torch.from_numpy(words.view(np.int32)).to(dev)
    return (spec, progs, tp.decode_batch_ref(w, combo, BATCH, BATCH, bases),
            (w, combo, bases))


def same_bits(a: torch.Tensor, b: torch.Tensor, plane: str = "") -> bool:
    """Equal, float32 compared by its bits (-0.0 is not +0.0), except a
    MIN/MAX plane, whose +0.0 / -0.0 depends on the order of the updates
    (in the reference too) and is compared by value."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32 and not plane.endswith(("_min", "_max")):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def expr_cases():
    """Expressions over every op and type mix the device takes."""
    from hstream_tpu_torch.engine.expr import BinOp as B
    from hstream_tpu_torch.engine.expr import Col as C
    from hstream_tpu_torch.engine.expr import Lit as L
    from hstream_tpu_torch.engine.expr import UnOp as U

    f, g, i, j, b, c = (C(x) for x in "fgijbc")
    pairs = [(f, g), (i, j), (i, f), (f, j), (b, i), (f, b), (b, c),
             (i, L(3)), (f, L(2.5)), (L(7), j), (b, L(True)), (L(-7), i),
             (g, L(-3.0))]
    out = []
    for x, y in pairs:
        for op in ("+", "-", "*", "/", "%", "=", "<>", "<", "<=", ">",
                   ">="):
            if not (op == "-" and x in (b,) and y in (c, L(True))):
                out.append(B(op, x, y))
    for op in ("AND", "OR"):
        out += [B(op, b, c), B(op, i, j), B(op, b, i),
                B(op, B(">", f, L(0.0)), c)]
    out += [U("NEG", b), B("-", b, c), B("AND", f, b), U("NOT", f),
            U("ROUND", b), U("SIGN", b)]       # refused at compile
    out += [U("NOT", b), U("NOT", i), U("NEG", i), U("NEG", f),
            U("ABS", i), U("ABS", f), U("ABS", b),
            B("+", B("*", f, L(1.8)), L(32)),          # the changelog's
            B("*", i, L(65536)), B("+", i, L(2147483647)),   # int wrap
            B("-", L(-2147483648), i), U("NEG", B("%", i, j)),
            B("AND", B(">", f, g), U("NOT", B("=", i, L(0)))),
            B("/", B("%", f, g), B("-", i, j))]
    # both sides computed, so the register form spills (expr.lower): a
    # right-deep chain of products, a balanced tree of 16 leaves that
    # keeps three slots, a unary of a difference of unaries
    deep = B("-", f, B("*", g, f))
    for x, y in ((i, j), (b, g), (f, L(0.5)), (j, c)):
        deep = B("+", B("*", x, y), deep)
    leaves = [f, g, i, j, b, c, L(3), L(-2.5)] * 2
    ops = ["*", "-", "+", "/", "%", "<", "*", "+"]
    while len(leaves) > 1:
        leaves = [B(ops[k % len(ops)], leaves[k], leaves[k + 1])
                  for k in range(0, len(leaves), 2)]
    out += [deep, leaves[0], U("NEG", B("-", U("ABS", f), U("ABS", g)))]
    return out


def expr_columns(dev, n: int, seed: int):
    rng = np.random.default_rng(seed)
    f = (rng.normal(0, 100, n)).astype(np.float32)
    f[::7] = np.rint(f[::7])
    f[::101] = np.nan
    f[1::103] = np.inf
    f[2::107] = -np.inf
    f[3::109] = -0.0
    f[4::113] = 0.0
    f[5::127] = 1e30
    f[6::131] = 1e-40                       # subnormal
    g = rng.normal(0, 3, n).astype(np.float32)
    g[::11] = 0.0
    g[1::13] = -0.0
    g[2::17] = np.nan
    g[3::19] = np.inf
    g[4::23] = -np.rint(g[4::23])
    i = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    i[::5] = rng.integers(-10, 10, i[::5].shape[0])
    i[1::29] = -(1 << 31)
    i[2::31] = (1 << 31) - 1
    j = rng.integers(-5, 6, n).astype(np.int32)       # zeros, -1, negatives
    j[::37] = -(1 << 31)
    j[1::41] = (1 << 31) - 1
    b = rng.integers(0, 2, n).astype(np.bool_)
    c = rng.integers(0, 2, n).astype(np.bool_)
    return {k: torch.from_numpy(v).to(dev) for k, v in
            dict(f=f, g=g, i=i, j=j, b=b, c=c).items()}


def check_expr(dev, results, chg):
    """K1: every op on int/float/bool mixes, int overflow, % with
    negative operands, division by zero, NaN and +-inf, programs that
    spill (expr.lower), exact against the plain version, on a batch of
    2^16 records, on one of 2^16 - 3 (not a multiple of the records a
    thread takes) and on that one with every column and `valid` one
    element off their allocation (the kernel's scalar path); then timed
    on the changelog query's programs."""
    from hstream_tpu_torch.common.errors import SQLCodegenError
    from hstream_tpu_torch.engine import expr as ex
    from hstream_tpu_torch.engine.kernels import binding as kb
    from hstream_tpu_torch.engine.types import ColumnType as CT, Schema

    schema = Schema.of(f=CT.FLOAT, g=CT.FLOAT, i=CT.INT, j=CT.INT,
                       b=CT.BOOL, c=CT.BOOL)
    progs, refused = [], 0
    for e in expr_cases():
        try:
            progs.append(ex.compile_device(e, schema))
        except SQLCodegenError:
            refused += 1
    slots = max(ex.lower(p).slots for p in progs)
    assert slots >= 3, slots
    where = ex.compile_device(ex.BinOp("<>", ex.Col("f"), ex.Col("g")),
                              schema)
    full = expr_columns(dev, (1 << 16) + 1, 31)
    valid_full = torch.from_numpy(np.random.default_rng(32).integers(
        0, 9, (1 << 16) + 1) > 0).to(dev)
    odd = (1 << 16) - 3
    assert odd % kb.EXPR_PER != 0
    dtypes = set()
    for n, at in ((1 << 16, 0), (odd, 0), (odd, 1)):
        cols = {k: v[at:at + n] for k, v in full.items()}
        valid0 = valid_full[at:at + n]
        for k in range(0, len(progs), 12):
            chunk = [(p, f"__e{k + m}")
                     for m, p in enumerate(progs[k:k + 12])]
            got, valid = dict(cols), valid_full.clone()[at:at + n]
            ex.eval_programs(chunk + [(where, None)], got, valid)
            torch.cuda.synchronize()
            for p, name in chunk:
                want = p(cols)
                dtypes.add(p.dtype)
                if not same_bits(got[name], want):
                    g, w = got[name], want
                    if g.dtype == torch.float32:
                        g, w = g.view(torch.int32), w.view(torch.int32)
                    bad = torch.nonzero(g != w).reshape(-1)[:6].tolist()
                    ins = {c: [hex(int(cols[c].view(torch.int32)[q]))
                               if cols[c].dtype == torch.float32
                               else int(cols[c][q]) for q in bad]
                           for c in p.cols}
                    raise AssertionError(
                        f"expression {k} (n {n}, offset {at}): {name} "
                        f"differs at {bad}: inputs {ins}, kernel "
                        f"{[hex(int(g[q])) for q in bad]}, plain "
                        f"{[hex(int(w[q])) for q in bad]}")
            assert torch.equal(valid, valid0 & where(cols)), \
                f"expression: WHERE (n {n}, offset {at})"
    assert dtypes == {"f32", "i32", "bool"}, dtypes
    # timed on the changelog query's programs and batch
    _, prog_list, (key, ts, valid, ccols), _ = chg
    vcopy = valid.clone()
    ms, call, src = kernel_ms(lambda: ex.eval_programs(
        prog_list, dict(ccols), vcopy), 50)
    plain = kernel_ms(lambda: [p(ccols) for p, _ in prog_list], 20)[0]
    n_ops = sum(len(p.ops) for p, _ in prog_list)
    b_ms, b_by = bound(BATCH * (4 + 1 + 1 + 4), BATCH * n_ops)
    results["expression"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/expr.cu",
        replaces="hstream_tpu/engine/lattice.py:169",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src)
    log(f"expression: {len(progs)} programs bit-exact ({refused} refused "
        f"at compile; up to {slots} spill slots) on 2^16 records, 2^16 - 3 "
        f"and 2^16 - 3 unaligned; {ms:.4f} ms (plain {plain:.4f}, "
        f"bound {b_ms:.4f})")


def wide_programs():
    """(columns, programs) past one argument block of the expression
    kernel: 24 programs over 20 int columns (each a chain over eight of
    them, ~30 instructions), a program over 80 columns (past a block's
    column table) and one of ~500 instructions (each cut into pieces
    by expr.launch_plan), and a WHERE."""
    from hstream_tpu_torch.engine import expr as ex
    from hstream_tpu_torch.engine.types import ColumnType as CT, Schema

    names = [f"x{k}" for k in range(20)]
    extra = [f"y{k}" for k in range(80)]
    schema = Schema.of(**{c: CT.INT for c in names + extra})

    def total(cols):
        e = ex.Col(cols[0])
        for c in cols[1:]:
            e = ex.BinOp("+", e, ex.Col(c))
        return e

    progs = []
    for p in range(24):
        e = ex.Col(names[p % 20])
        for k in range(1, 8):
            c = ex.Col(names[(p + 3 * k) % 20])
            e = ex.BinOp("-" if k % 3 else "*", ex.BinOp("+", e, c),
                         ex.Lit(k))
        progs.append((ex.compile_device(e, schema), f"p{p}"))
    wide = ex.compile_device(ex.BinOp("*", ex.BinOp(
        "+", total(extra[:40]), ex.Lit(3)), total(extra[40:])), schema)
    long = ex.compile_device(ex.BinOp("-", total(names * 25),
                                      ex.Col(names[0])), schema)
    where = ex.compile_device(ex.BinOp(">", total(names[5:9]),
                                       ex.Lit(-200)), schema)
    return names + extra, tuple(progs), wide, long, where


def check_expr_blocks(dev, results):
    """The expression kernel past one argument block: 24 programs over
    20 columns with a WHERE (two blocks, launched in turn), a program
    over 80 columns and one of ~500 instructions (pieces passing
    temporary columns), each bit-exact against its plain version on
    2^16 and 2^16 - 3 records."""
    from hstream_tpu_torch.engine import expr as ex

    names, progs, wide, long, where = wide_programs()
    rng = np.random.default_rng(41)
    sets = [progs + ((where, None),), ((wide, "wide"),), ((long, "long"),)]
    blocks = []
    for n in (1 << 16, (1 << 16) - 3):
        cols = {c: torch.from_numpy(rng.integers(-1000, 1000, n)
                                    .astype(np.int32)).to(dev)
                for c in names}
        valid0 = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        for pset in sets:
            plan = ex.launch_plan(pset)
            got, valid = dict(cols), valid0.clone()
            before = ex.eval_programs.launches
            ex.eval_programs(pset, got, valid)
            torch.cuda.synchronize()
            assert ex.eval_programs.launches - before == len(plan.blocks)
            assert not (set(got) - set(cols)) & plan.temps
            want_valid = valid0.clone()
            for prog, name in pset:
                want = prog(cols)
                if name is None:
                    want_valid &= want
                else:
                    assert torch.equal(got[name], want), \
                        f"expression blocks: {name} (n {n}) differs"
            assert torch.equal(valid, want_valid), "expression blocks: WHERE"
            blocks.append(len(plan.blocks))
    results["expression"]["blocks_checked"] = blocks
    log(f"expression past one argument block: 24 programs over 20 columns "
        f"and a WHERE, an 80-column and a ~500-instruction program "
        f"(blocks {blocks[:3]}), bit-exact on 2^16 and 2^16 - 3 records")


# CUDA's documented largest error of each single-precision function, in
# ULP (CUDA C++ Programming Guide, "Mathematical Functions", single
# precision); the kernel and the plain version on the card both call
# CUDA's functions, so they may differ by twice that. CEIL, FLOOR,
# ROUND, SIGN and SQRT (__fsqrt_rn, and the plain version's float64
# sqrt rounded once) are exact.
CUDA_ULP = {"SIN": 2, "COS": 2, "TAN": 4, "ASIN": 2, "ACOS": 2, "ATAN": 2,
            "SINH": 3, "COSH": 2, "TANH": 2, "ASINH": 3, "ACOSH": 4,
            "ATANH": 3, "LOG": 1, "LOG2": 1, "LOG10": 2, "EXP": 2}
CARD_ULP = {k: 2 * v for k, v in CUDA_ULP.items()}
EXACT_UNARY = ("CEIL", "FLOOR", "ROUND", "SIGN", "SQRT")


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 units in the last place (ordered int bits)."""
    ai, bi = (x.view(torch.int32).long() for x in (a, b))
    ai = torch.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = torch.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return (ai - bi).abs()


def unary_columns(dev, n: int, seed: int):
    """f: normal(0, 10) with NaN, +-inf, +-0, halves (x.5, -x.5, 20.5,
    -0.5), inputs outside the domains (negatives for SQRT and the logs,
    |x| > 1 for ASIN, ACOS and ATANH, x < 1 for ACOSH, +-1 for ATANH),
    large arguments (1e4 .. 3.4e38), values past exp's and sinh's
    overflow, subnormals and the smallest normals; i: int32 over its
    range and small; b: bools."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 10, n).astype(np.float32)
    f[::5] = np.rint(f[::5] * 2) / 2             # halves and integers
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5,
                        1.5, -1.5, 2.5, -2.5, 20.5, -20.5, 1.0, -1.0, 0.99,
                        -0.99, 1.01, -3.0, 0.25, 1e4, -1e4, 1e10, -1e20,
                        1e30, 3.4e38, -3.4e38, 88.0, 89.0, -104.0, 710.0,
                        16.0, 16.1, 15.9,
                        # subnormals and the smallest normals: flushed
                        # where XLA flushes them (expr.ftz)
                        1e-45, -1e-45, 1e-40, -3e-39, 1.1754944e-38,
                        -1.1754944e-38, 2e-38], np.float32)
    f[: len(special)] = special
    f[len(special)::97] = -np.abs(f[len(special)::97])
    i = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    i[::3] = rng.integers(-100, 100, i[::3].shape[0])
    i[:6] = [0, 1, -1, -(1 << 31), (1 << 31) - 1, 2]
    b = rng.integers(0, 2, n).astype(np.bool_)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in dict(f=f, i=i, b=b).items()}


def log_programs():
    """Phase 11's step programs (LOG_SQL's WHERE and computed inputs),
    from the port's SQL front end."""
    from hstream_tpu_torch.engine import FilterNode, lattice
    from hstream_tpu_torch.engine.types import ColumnType as CT, Schema
    from hstream_tpu_torch.sql import stream_codegen

    node = stream_codegen(LOG_SQL).select.node
    assert isinstance(node.child, FilterNode), node.child
    schema = Schema.of(device=CT.STRING, temp=CT.FLOAT)
    spec = lattice.LatticeSpec(n_keys=1024, window=node.window,
                               aggs=tuple(node.aggs), track_touched=False)
    return lattice.step_programs(spec, schema, node.child.predicate)


def check_unaries(dev, results):
    """B1b': the expression kernel's unaries, each on every operand type
    the reference takes (ROUND and SIGN of a bool are refused at
    compile), against the plain version on the card: the exact ones bit
    for bit (a NaN as a NaN), the rest NaN, +-inf and zero where the
    plain version has them and within CARD_ULP elsewhere. Then phase
    11's programs over a 2^20-record batch of phase 11's own stream,
    against the plain programs on the same tensors: the WHERE mask and
    the SQRT, ROUND and CEIL programs bit for bit, the LOG10 and EXP
    programs within CARD_ULP of their outer function; timed there."""
    from hstream_tpu_torch.common.errors import SQLCodegenError
    from hstream_tpu_torch.engine import expr as ex
    from hstream_tpu_torch.engine.kernels import binding as kb
    from hstream_tpu_torch.engine.types import ColumnType as CT, Schema

    schema = Schema.of(f=CT.FLOAT, i=CT.INT, b=CT.BOOL)
    ops = EXACT_UNARY + tuple(CARD_ULP)
    cases, refused = [], []
    for op in ops:
        for col in "fib":
            try:
                cases.append((op, col, ex.compile_device(
                    ex.UnOp(op, ex.Col(col)), schema)))
            except SQLCodegenError:
                refused.append(f"{op}({col})")
    assert sorted(refused) == ["ROUND(b)", "SIGN(b)"], refused
    cols = unary_columns(dev, 1 << 16, 41)
    valid = torch.ones(1 << 16, dtype=torch.bool, device=dev)
    worst: dict[str, int] = {}
    max_abs = 0.0
    step = kb.EXPR_MAX_PROGS
    for k in range(0, len(cases), step):
        chunk = cases[k:k + step]
        got = dict(cols)
        ex.eval_programs([(p, f"__u{k + m}") for m, (_, _, p) in
                          enumerate(chunk)], got, valid)
        torch.cuda.synchronize()
        for m, (op, col, p) in enumerate(chunk):
            g, w = got[f"__u{k + m}"], p(cols)
            what = f"{op}({col})"
            assert g.dtype == w.dtype, what
            if g.dtype != torch.float32:
                assert torch.equal(g, w), what
                continue
            gn, wn = torch.isnan(g), torch.isnan(w)
            assert torch.equal(gn, wn), f"{what}: NaN positions differ"
            odd = ~torch.isfinite(w) | (w == 0)
            assert torch.equal(g[odd & ~wn], w[odd & ~wn]), \
                f"{what}: inf or zero differs"
            d = ulp_distance(g[~wn], w[~wn])
            worst[op] = max(worst.get(op, 0), int(d.max().item()))
            fin = torch.isfinite(w)
            if fin.any():
                max_abs = max(max_abs, float((g[fin] - w[fin]).abs().max()))
            lim = 0 if op in EXACT_UNARY else CARD_ULP[op]
            assert worst[op] <= lim, f"{what}: {worst[op]} ULP > {lim}"
    # phase 11's programs over a batch of phase 11's stream
    progs = log_programs()
    temp = torch.from_numpy(Batches(LOG_SEED).get(0)[2]).to(dev)
    tcols = {"temp": temp}
    got = dict(tcols)
    vcopy = torch.ones(BATCH, dtype=torch.bool, device=dev)
    ex.eval_programs(progs, got, vcopy)
    torch.cuda.synchronize()
    outer = {ex.OP_LOG10_F: "LOG10", ex.OP_EXP_F: "EXP"}
    path_ulp: dict[str, int] = {}
    for p, name in progs:
        want = p(tcols)
        if name is None:
            assert torch.equal(vcopy, want), "phase 11's WHERE mask"
            continue
        g, op = got[name], outer.get(p.ops[-1][0])
        what = f"phase 11's {name} ({op or 'exact'})"
        assert g.dtype == want.dtype and bool(torch.isfinite(want).all()) \
            and bool(torch.isfinite(g).all()), what
        path_ulp[name] = int(ulp_distance(g, want).max().item())
        lim = CARD_ULP[op] if op else 0
        assert path_ulp[name] <= lim, f"{what}: {path_ulp[name]} > {lim}"
        max_abs = max(max_abs, float((g - want).abs().max()))
    ms, call, src = kernel_ms(lambda: ex.eval_programs(
        progs, dict(tcols), vcopy), 50)
    plain = kernel_ms(lambda: [p(tcols) for p, _ in progs], 20)[0]
    lib = kernel_ms(lambda: torch.sqrt(temp), 50)[0]
    n_out = sum(1 for _, name in progs if name is not None)
    n_ops = sum(len(p.ops) for p, _ in progs)
    # each record reads temp and valid and writes valid and the inputs
    b_ms, b_by = bound(BATCH * (4 + 1 + 1 + 4 * n_out), BATCH * n_ops)
    results["expression_unaries"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/expr.cu",
        replaces="hstream_tpu/engine/expr.py:70",
        max_abs_err=max_abs, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, call_ms=call, ms_source=src,
        max_ulp=worst, card_ulp=CARD_ULP, programs=len(progs),
        ops=n_ops, path_max_ulp=path_ulp)
    log(f"expression unaries: {len(cases)} programs ({len(refused)} "
        f"refused at compile), largest ULP against the plain version "
        f"{json.dumps(worst)}; phase 11's {len(progs)} programs "
        f"({n_ops} ops) against plain on its stream, largest ULP "
        f"{json.dumps(path_ulp)}, mask exact; {ms:.4f} ms device, {call:.4f} ms a call (plain "
        f"{plain:.4f}, torch.sqrt {lib:.4f}, bound {b_ms:.4f} by {b_by})")


def k2_spec(n_keys: int = 1024):
    """Every scatter kind with a NULL mask of its own."""
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import TumblingWindow, lattice
    from hstream_tpu_torch.engine.expr import Col

    x = Col("temp")
    aggs = (AggSpec(A.COUNT_ALL, "call"), AggSpec(A.COUNT, "c", input=x),
            AggSpec(A.SUM, "s", input=x), AggSpec(A.AVG, "a", input=x),
            AggSpec(A.MIN, "lo", input=x), AggSpec(A.MAX, "hi", input=x),
            AggSpec(A.APPROX_COUNT_DISTINCT, "u", input=x),
            AggSpec(A.APPROX_QUANTILE, "q99", input=x, quantile=0.99),
            AggSpec(A.APPROX_QUANTILE, "q1", input=x, quantile=1.0),
            AggSpec(A.APPROX_QUANTILE, "q0", input=x, quantile=1e-30),
            # q = 0 finalizes as the median in both engines (`or 0.5`)
            AggSpec(A.APPROX_QUANTILE, "qz", input=x, quantile=0.0),
            AggSpec(A.TOPK, "t", input=x, k=3),
            AggSpec(A.TOPK_DISTINCT, "td", input=x, k=2))
    return lattice.LatticeSpec(n_keys=n_keys,
                               window=TumblingWindow(10_000, grace_ms=0),
                               aggs=aggs, track_touched=True)


def k2_inputs(dev, seed: int, n_keys: int = 1024):
    """awkward_inputs, with quantile-awkward values (<= 0, in
    (0, min_value), above max_value, non-finite) and a NULL mask per
    aggregate; key 7's inputs are all NULL or non-finite, so its cells
    count records but hold an empty histogram."""
    key, ts, valid, cols = awkward_inputs(dev, seed)
    rng = np.random.default_rng(seed + 100)
    n = key.shape[0]
    t = cols["temp"].cpu().numpy().copy()
    t[7::211] = -rng.random(t[7::211].shape[0]).astype(np.float32)
    t[8::223] = 0.0
    t[9::227] = (rng.random(t[9::227].shape[0]) * 9e-7).astype(np.float32)
    t[10::229] = 1e6 * rng.integers(1000, 100_000, t[10::229].shape[0])
    t[11::233] = 1e-6
    k = key.cpu().numpy().copy()
    if n_keys > 1024:      # spread the keys over the wider lattice
        k = np.where(k < 1024, k * (n_keys // 1024), k - 1024 + n_keys)
    k[13::499] = 7
    t[k == 7] = np.where(rng.random(int((k == 7).sum())) < 0.5, np.nan,
                         np.inf)
    out = {"temp": torch.from_numpy(t).to(dev)}
    for i in range(len(k2_spec().aggs)):
        out[f"__null_a{i}"] = torch.from_numpy(rng.random(n) < 0.02).to(dev)
    return torch.from_numpy(k).to(dev), ts, valid, out


def check_sketch_aggs(dev, results):
    """K2: the scatter's NULL masks, COUNT(col) and quantile bins, and the
    close's quantile estimate and TOPK rows, exact against the plain
    versions (SUM/AVG sums within the atomic-order bound)."""
    from hstream_tpu_torch.engine import lattice

    spec = k2_spec()
    wm = 205_000
    key, ts, valid, cols = k2_inputs(dev, 41)
    state = lattice.init_state(spec, dev)
    err = 0.0
    for rnd in range(2):
        a, b = copy_state(state), copy_state(state)
        lattice.scatter_step(spec, a, wm, key, ts, valid, cols)
        lattice.topk_step(spec, a, wm, key, ts, valid, cols)
        lattice.scatter_step_ref(spec, b, wm, key, ts, valid, cols)
        lattice.topk_step_ref(spec, b, wm, key, ts, valid, cols)
        torch.cuda.synchronize()
        absd = lattice.init_state(spec, dev)
        lattice.scatter_step_ref(spec, absd, wm, key, ts, valid,
                                 dict(cols, temp=cols["temp"].abs()))
        n = b["count"].double() + 1   # addends, the prior value as one
        for k in b:
            if k in ("a2_sum", "a3_avg"):
                lim = 2 * n * U * (absd[k].double() * (1 + 1e-6)
                                   + state[k].double().abs())
                d = (a[k].double() - b[k].double()).abs()
                assert bool((d <= lim).all()), f"K2 round {rnd}: {k}"
                err = max(err, d.max().item())
            else:
                assert same_bits(a[k], b[k], k), \
                    f"K2 round {rnd}: {k} differs"
        state = b
    hist = state["a7_approx_quantile"]
    assert int(hist[7].sum()) == 0 and int(state["count"][7].sum()) > 0, \
        "key 7 should hold an empty histogram"
    assert int(hist[:, :, 0].sum()) > 0 and int(hist[:, :, -1].sum()) > 0
    for sl, mode in (([0, 1, 2], lattice.CLOSE_EXTRACT),
                     ([2, 0], lattice.CLOSE_EXTRACT_RESET),
                     ([1], lattice.CLOSE_RESET)):
        slots = lattice.pad_slots(sl)
        a, b = copy_state(state), copy_state(state)
        got = lattice.close_slots(spec, a, slots, mode)
        st = torch.from_numpy(slots).to(dev)
        want = None
        if mode != lattice.CLOSE_RESET:
            want = lattice.extract_slots_ref(spec, b, st)
        if mode != lattice.CLOSE_EXTRACT:
            lattice.reset_slots_ref(spec, b, st)
        torch.cuda.synchronize()
        if want is not None:
            assert torch.equal(got, want), f"K2 close {sl} {mode}: rows"
        for k in b:
            assert torch.equal(a[k], b[k]), f"K2 close {sl} {mode}: {k}"
    sc = results["scatter_aggregate"]
    sc["max_abs_err"] = max(sc["max_abs_err"], err)
    log(f"scatter/close sketch kinds: NULL masks, COUNT(col), quantile bins "
        f"and estimates (q 0.99, 1, 1e-30, 0, an empty histogram), TOPK "
        f"rows exact; SUM/AVG within the bound (max err {err:.3g})")
    return state


def topk_inputs(dev, seed: int):
    """Ties, -0.0 / +0.0, subnormals of both signs (ranked as zeros), NaN
    and +-inf, cells with fewer records than k."""
    rng = np.random.default_rng(seed)
    n = 1 << 18
    pool = np.array([-2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 1.0, 2.0, 3.0, np.nan,
                     np.inf, -np.inf, 1e30, -1e30, 1e-45, -1e-45, 3e-39,
                     -3e-39], np.float32)
    v = pool[rng.integers(0, len(pool), n)]
    v[::3] = (rng.normal(0, 2, v[::3].shape[0]) * 4).round() / 4
    key = rng.integers(0, 600, n).astype(np.int32)
    key[::97] = rng.integers(600, 1024, key[::97].shape[0])  # 1-3 records
    zs = key >= 960             # cells of zeros and subnormals alone
    v[zs] = np.array([0.0, -0.0, 1e-45, -1e-45, 3e-39, -3e-39],
                     np.float32)[rng.integers(0, 6, int(zs.sum()))]
    ts = (200_000 + rng.integers(0, 30_000, n)).astype(np.int32)
    valid = rng.integers(0, 30, n) > 0
    cols = {"temp": torch.from_numpy(v).to(dev)}
    for i in range(4):
        cols[f"__null_a{i}"] = torch.from_numpy(rng.random(n) < 0.03).to(dev)
    t = torch.from_numpy
    return t(key).to(dev), t(ts).to(dev), t(valid).to(dev), cols


def topk_spec(n_keys: int = 1024):
    """check_topk's lattice: TOPK and TOPK_DISTINCT at k = 3 and 1."""
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import TumblingWindow, lattice
    from hstream_tpu_torch.engine.expr import Col

    x = Col("temp")
    return lattice.LatticeSpec(
        n_keys=n_keys, window=TumblingWindow(10_000, grace_ms=0),
        aggs=(AggSpec(A.TOPK, "t3", input=x, k=3),
              AggSpec(A.TOPK_DISTINCT, "d3", input=x, k=3),
              AggSpec(A.TOPK, "t1", input=x, k=1),
              AggSpec(A.TOPK_DISTINCT, "d1", input=x, k=1)))


def topk_vs_plain(spec, state, wm, key, ts, valid, cols, what: str,
                  mode=None) -> dict:
    """One top-k launch (in `mode`) bit for bit against the plain fold
    from the same state; returns the plain fold's state."""
    from hstream_tpu_torch.engine import lattice

    a, b = copy_state(state), copy_state(state)
    lattice.topk_step(spec, a, wm, key, ts, valid, cols, mode=mode)
    lattice.topk_step_ref(spec, b, wm, key, ts, valid, cols)
    torch.cuda.synchronize()
    for k in b:
        assert same_bits(a[k], b[k]), f"topk {what}: {k}"
    return b


def topk_edge_batches(dev):
    """(name, batches, n_keys): every record of a batch in one cell of a
    fresh plane (every candidate contends for it); two batches over the
    same cells, the second's values all above the first's, so a later
    batch raises every k-th value a block read, copied or cached while
    other blocks merge; and a lattice of 2^16 keys, whose planes exceed a
    block's shared memory."""
    rng = np.random.default_rng(53)
    n = 1 << 18
    t = torch.from_numpy

    def batch(key, v, ts=None):
        ts = (200_000 + rng.integers(0, 9_000, n) if ts is None else ts)
        cols = {"temp": t(v.astype(np.float32)).to(dev)}
        for i in range(4):
            cols[f"__null_a{i}"] = t(rng.random(n) < 0.02).to(dev)
        return (t(key.astype(np.int32)).to(dev),
                t(ts.astype(np.int32)).to(dev),
                t(rng.integers(0, 40, n) > 0).to(dev), cols)

    one = np.full(n, 7)
    ties = (rng.normal(0, 3, n) * 4).round() / 4
    keys = rng.integers(0, 1024, n)
    low, high = rng.random(n), 1.0 + rng.random(n)
    big = rng.integers(0, 1 << 16, n)
    return [("one cell", [batch(one, ties)], 1024),
            ("a later batch above the staged k-th",
             [batch(keys, low), batch(keys, high)], 1024),
            ("2^16 keys", [batch(big, ties), batch(big, ties + 1)],
             1 << 16)]


def check_topk(dev, results, chg):
    """K4: both variants bit-exact against the plain fold, k = 3 and 1,
    two rounds, in both branches (block-private and global); the edge
    batches (topk_edge_batches); then timed on the changelog batch, in
    steady state (the planes full) and on fresh planes (the first batch
    of a window)."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import binding as kb

    spec = topk_spec()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert lattice.topk_plan(spec, 1 << 18, n_sms).mode == kb.TOPK_PRIVATE
    branches = (("private", kb.TOPK_PRIVATE), ("global", kb.TOPK_GLOBAL))
    zeros = {}
    for bname, mode in branches:
        state = lattice.init_state(spec, dev)
        for rnd in range(2):
            key, ts, valid, cols = topk_inputs(dev, 50 + rnd)
            state = topk_vs_plain(spec, state, 205_000, key, ts, valid,
                                  cols, f"{bname} round {rnd}", mode)
        assert bool(torch.isneginf(state["a0_topk"][:, :, 2]).any()), \
            "no cell with fewer records than k"
        zeros[bname] = {
            k: (int((v.view(torch.int32) == 0).sum()),
                int((v.view(torch.int32) == -(1 << 31)).sum()))
            for k, v in state.items() if k.startswith("a")}
    edge = []
    for name, batches, n_keys in topk_edge_batches(dev):
        espec = topk_spec(n_keys)
        auto = lattice.topk_plan(espec, 1 << 18, n_sms).mode
        assert (auto == kb.TOPK_GLOBAL) == (n_keys > 1024), (name, auto)
        for rname, mode in (("auto", None), ("global", kb.TOPK_GLOBAL)):
            state = lattice.init_state(espec, dev)
            for bi, (key, ts, valid, cols) in enumerate(batches):
                state = topk_vs_plain(espec, state, 205_000, key, ts, valid,
                                      cols, f"{name}, {rname}, batch {bi}",
                                      mode)
        edge.append(name)
    # timed on the changelog batch: steady state, planes already filled
    cspec, progs, (key, ts, valid, cols), _ = chg
    from hstream_tpu_torch.engine import expr as ex

    cols, valid = dict(cols), valid.clone()
    ex.eval_programs(progs, cols, valid)
    st = lattice.init_state(cspec, dev)
    fresh = topk_vs_plain(cspec, st, -1, key, ts, valid, cols,
                          "changelog batch, fresh planes")
    st = topk_vs_plain(cspec, fresh, -1, key, ts, valid, cols,
                       "changelog batch, full planes")
    ms, call, src = kernel_ms(lambda: lattice.topk_step(
        cspec, st, -1, key, ts, valid, cols), 30)
    planes = [k for k in st if k.endswith(("_topk", "_topk_distinct"))]
    empty = {k: torch.full_like(st[k], float("-inf")) for k in planes}

    def refill():
        for k in planes:
            st[k].copy_(empty[k])

    refill_ms = kernel_ms(refill, 20)[0]
    ms_fresh = kernel_ms(lambda: (refill(), lattice.topk_step(
        cspec, st, -1, key, ts, valid, cols)), 20)[0] - refill_ms
    plain = kernel_ms(lambda: lattice.topk_step_ref(
        cspec, st, -1, key, ts, valid, cols), 3)[0]
    cell = key.long() * cspec.n_slots + torch.remainder(
        torch.div(ts, 10_000, rounding_mode="floor"), cspec.n_slots).long()
    okey = (cell << 32) | ((1 << 31) - 1 - lattice._order_key(cols["temp"]))
    lib = kernel_ms(lambda: torch.sort(okey), 10)[0]
    touched_cells = int(torch.unique(cell).numel())
    nbytes = BATCH * (4 + 4 + 1 + 4 + 2) + 2 * 2 * touched_cells * TOPK_K * 4
    b_ms, b_by = bound(nbytes, BATCH * 2 * 4)
    plan = lattice.topk_plan(cspec, BATCH, n_sms)
    results["topk_fold"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/topk.cu",
        replaces="hstream_tpu/engine/lattice.py:258",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, call_ms=call, ms_source=src,
        ms_fresh=ms_fresh, plan=plan._asdict(),
        smem_bytes=lattice.topk_smem_bytes(cspec))
    log(f"topk_fold: both variants, k 3 and 1, bit-exact in both branches "
        f"over ties, +-0.0, subnormals (kept +0.0/-0.0 per plane: "
        f"{zeros}), NaN, +-inf, short cells, and {', '.join(edge)}; "
        f"{ms:.4f} ms in steady state, {ms_fresh:.4f} ms on fresh planes "
        f"(plain {plain:.4f}, library sort {lib:.4f}, bound {b_ms:.4f}; "
        f"mode {plan.mode}, {plan.blocks} blocks)")


JOIN_TOUCHED = "join (BASELINE 5)"   # the path of B6's second shape


def k2_scalar_spec(n_keys: int = 1024, window: bool = True):
    """k2_spec's scalar aggregates only (COUNT(*), COUNT, SUM, AVG, MIN,
    MAX): the touched extract's thread-per-column finalize alone;
    windowless, a lattice of n_keys cells."""
    from hstream_tpu_torch.engine import lattice

    spec = k2_spec(n_keys)
    return lattice.LatticeSpec(n_keys=n_keys,
                               window=spec.window if window else None,
                               aggs=spec.aggs[:6], track_touched=True)


def touched_vs_plain(sp, s0, mo, mode, what):
    """The touched extract in `mode` and its plain version, each on its
    own copy of s0: the packed buffer bit for bit, touched cleared, the
    other planes untouched."""
    from hstream_tpu_torch.engine import lattice

    a, b = copy_state(s0), copy_state(s0)
    got = lattice.extract_touched(sp, a, mo, mode=mode)
    want = lattice.extract_touched_ref(sp, b, mo)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"touched {what}: packed rows differ"
    assert not bool(a["touched"].any()), f"touched {what}: not cleared"
    for k in b:
        assert torch.equal(a[k], b[k]), f"touched {what}: {k}"


def touched_bound(spec, state, n: int, mo: int) -> tuple[float, str]:
    """B6's bound, bytes once: the flags read, the set ones cleared, the
    touched cells' count and aggregate planes gathered, the buffer
    written; the sketch estimates' operations beside them."""
    from hstream_tpu_torch.engine import lattice

    cells = spec.n_keys * spec.n_slots
    per_cell = sum(int(v.nbytes) // cells for k, v in state.items()
                   if k not in ("slot_start", "touched"))
    rows = 3 + lattice.out_rows(spec)
    sketch = sum(int(state[lattice._plane_name(i, g)].nbytes) // cells
                 for i, g in enumerate(spec.aggs)
                 if g.kind.name in ("APPROX_COUNT_DISTINCT", "APPROX_QUANTILE"))
    return bound(cells + n + n * per_cell + rows * mo * 4, n * 3 * sketch)


def check_touched(dev, results, k2_state, chg):
    """K3: every forced mode (one launch where the lattice fits it, and
    staged) on k2's every-kind spec (HLL, quantile, TOPK) and on its
    scalar aggregates alone: as stepped, nothing touched, everything,
    n = max_out and n > max_out; windowless lattices of exactly 4096
    and 4097 cells; lattices of more than one 4096-cell tile, and of
    more than 2^25 cells (over 32 rounds of the look-back); packed
    buffers exact. Then timed at the changelog path's shapes in both
    modes (does the single-chunk lattice need a second launch?)."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import binding as kb

    cases = []
    for sp in (k2_spec(), k2_scalar_spec()):
        st = lattice.init_state(sp, dev)
        key, ts, valid, cols = k2_inputs(dev, 59)
        lattice.scatter_step_ref(sp, st, 205_000, key, ts, valid, cols)
        lattice.topk_step_ref(sp, st, 205_000, key, ts, valid, cols)
        cells = sp.n_keys * sp.n_slots
        n_hit = int(st["touched"].sum())
        tag = f"{len(sp.aggs)} aggs"
        cases.append((f"{tag}, as stepped", sp, st, cells))
        nothing = copy_state(st)
        nothing["touched"].zero_()
        cases.append((f"{tag}, nothing", sp, nothing, cells))
        every = copy_state(st)
        every["touched"].fill_(True)
        cases.append((f"{tag}, everything", sp, every, cells))
        cases.append((f"{tag}, n = max_out", sp, st, n_hit))
        cases.append((f"{tag}, n > max_out", sp, st, n_hit // 2))
    cases.append(("k2 state", k2_spec(), k2_state, 3072))
    for k in (4096, 4097):     # windowless: exactly 4096 and 4097 cells
        sp = k2_scalar_spec(k, window=False)
        key, ts, valid, cols = k2_inputs(dev, 61)
        key = torch.remainder(key * 5, k)
        st = lattice.init_state(sp, dev)
        lattice.scatter_step_ref(sp, st, -1, key, ts, valid, cols)
        cases.append((f"{k} cells", sp, st, k))
        cases.append((f"{k} cells, n > max_out", sp, st, 1000))
    for big in (2048, 6000):
        bspec = k2_spec(big)
        key, ts, valid, cols = k2_inputs(dev, 60 + big, big)
        bst = lattice.init_state(bspec, dev)
        lattice.scatter_step_ref(bspec, bst, 205_000, key, ts, valid, cols)
        lattice.topk_step_ref(bspec, bst, 205_000, key, ts, valid, cols)
        cases.append((f"K*W = {big * 3}", bspec, bst, big * 3))
        full = copy_state(bst)
        full["touched"].fill_(True)
        cases.append((f"K*W = {big * 3}, everything", bspec, full, big * 3))
    # past 2^25 cells: a tile's look-back reads more than 32 rounds of
    # status words (256 a round); a quarter of the flags set besides
    huge = (1 << 25) + 4097
    hspec = k2_scalar_spec(huge, window=False)
    key, ts, valid, cols = k2_inputs(dev, 62, huge)
    hst = lattice.init_state(hspec, dev)
    lattice.scatter_step_ref(hspec, hst, -1, key, ts, valid, cols)
    gen = torch.Generator(device=dev).manual_seed(63)
    hst["touched"] |= torch.rand(hst["touched"].shape, generator=gen,
                                 device=dev) < 0.25
    n_huge = int(hst["touched"].sum())
    cases.append((f"{huge} cells", hspec, hst, n_huge))
    cases.append((f"{huge} cells, n > max_out", hspec, hst, n_huge // 3))
    n_runs = 0
    for name, sp, s0, mo in cases:
        modes = [kb.TOUCHED_STAGED]
        if lattice.touched_plan(sp, mo) == kb.TOUCHED_ONE:
            modes.append(kb.TOUCHED_ONE)
        for mode in modes:
            touched_vs_plain(sp, s0, mo, mode, f"{name} (mode {mode})")
            n_runs += 1
    # timed at the changelog path's shapes: one headline batch touched
    # one slot of every key; the single launch and the staged one
    cspec, progs, (key, ts, valid, cols), _ = chg
    cst = lattice.init_state(cspec, dev)
    lattice.step_decoded(cspec, cst, -1, key, ts, valid.clone(), dict(cols),
                         progs)
    saved = cst["touched"].clone()
    mo = lattice.touched_max_out(cspec, BATCH)
    refill, refill_call, _ = kernel_ms(
        lambda: cst["touched"].copy_(saved), 50)
    by_mode = {}
    for mode in (kb.TOUCHED_ONE, kb.TOUCHED_STAGED, kb.TOUCHED_ONE):
        ms, call, src = kernel_ms(lambda: (
            cst["touched"].copy_(saved),
            lattice.extract_touched(cspec, cst, mo, mode=mode)), 50)
        by_mode.setdefault(mode, []).append((ms - refill, call - refill_call,
                                             src))
    ms, call, src = by_mode[kb.TOUCHED_ONE][-1]
    staged_ms = by_mode[kb.TOUCHED_STAGED][0][0]
    plain = kernel_ms(lambda: (cst["touched"].copy_(saved),
                               lattice.extract_touched_ref(cspec, cst, mo)),
                      10)[0] - refill
    lib = kernel_ms(lambda: torch.nonzero(saved), 50)[0]
    n = int(saved.sum())
    cst["touched"].copy_(saved)
    b_ms, b_by = touched_bound(cspec, cst, n, mo)
    results["touched_extract"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/touched.cu",
        replaces="hstream_tpu/engine/lattice.py:693",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, call_ms=call, ms_source=src,
        ms_one_launch=[m for m, _, _ in by_mode[kb.TOUCHED_ONE]],
        ms_staged=staged_ms, touched=n, max_out=mo,
        skip_paths=[JOIN_TOUCHED])
    log(f"touched_extract: {n_runs} runs over {len(cases)} cases bit-exact "
        f"(both modes; every kind and scalars only; n = 0, all, n = and > "
        f"max_out; 4096 and 4097 cells; 2 and 5 tiles; {huge} cells); "
        f"changelog shape "
        f"{ms:.4f} ms in one launch (again "
        f"{by_mode[kb.TOUCHED_ONE][0][0]:.4f}), staged {staged_ms:.4f}, "
        f"for {n} cells (plain {plain:.4f}, library nonzero {lib:.4f}, "
        f"bound {b_ms:.4f})")


def time_reset_close(dev, results, chg):
    """B5: the reset-only close, timed alone at the changelog path's
    shapes (one due slot of K=1024, 2 KiB of quantile bins per cell)."""
    from hstream_tpu_torch.engine import lattice

    cspec, progs, (key, ts, valid, cols), _ = chg
    st = lattice.init_state(cspec, dev)
    lattice.step_decoded(cspec, st, -1, key, ts, valid.clone(), dict(cols),
                         progs)
    slot = int(torch.nonzero(st["count"].sum(0))[0])
    slots = lattice.pad_slots([slot])
    a, b = copy_state(st), copy_state(st)
    lattice.reset_slots(cspec, a, slots)
    lattice.reset_slots_ref(cspec, b, torch.from_numpy(slots).to(dev))
    torch.cuda.synchronize()
    for k in b:
        assert torch.equal(a[k], b[k]), f"reset close: {k}"
    ms, call, src = kernel_ms(lambda: lattice.reset_slots(cspec, st, slots),
                              50)
    slots_t = torch.from_numpy(slots).to(dev)
    plain = kernel_ms(lambda: lattice.reset_slots_ref(cspec, st, slots_t),
                      10)[0]
    per_cell = 4 + 1 + 4 + 4 + 4 * cspec.qcfg.n_bins + 2 * TOPK_K * 4
    b_ms, b_by = bound(cspec.n_keys * per_cell + 4, 0)
    results["reset_close"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/close.cu",
        replaces="hstream_tpu/engine/lattice.py:654",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src)
    log(f"reset_close: exact; {ms:.4f} ms (plain {plain:.4f}, bound "
        f"{b_ms:.5f})")


def time_changelog_step(dev, results, chg):
    """The decode and the scatter at the changelog path's shapes (its wire
    carries the valid and NULL streams; its scatter COUNT, SUM and the
    quantile bins)."""
    from hstream_tpu_torch.engine import expr as ex
    from hstream_tpu_torch.engine import lattice, transport as tp
    from hstream_tpu_torch.engine.kernels import binding as kb

    cspec, progs, (key, ts, valid, cols), (w, combo, bases) = chg
    dec = results["wire_decode"]
    dec["ms_changelog"] = kernel_ms(
        lambda: tp.decode_batch(w, combo, BATCH, BATCH, bases), 50)[0]
    # the decode's bound on this wire: the words read once, and per
    # record key, ts and temp (4 B each), valid and each NULL mask (1 B)
    # written once
    masks = sum(1 for c in cols if c.startswith("__null_a"))
    dec["bound_ms_changelog"], dec["bound_by_changelog"] = bound(
        w.numel() * 4 + BATCH * (3 * 4 + 1 + masks), BATCH * len(combo) * 8)
    log(f"wire_decode at the changelog path's shapes ({len(combo)} "
        f"streams): {dec['ms_changelog']:.4f} ms (bound "
        f"{dec['bound_ms_changelog']:.4f} by {dec['bound_by_changelog']})")
    from hstream_tpu_torch.engine.sketches import quantile_bin

    cols, valid = dict(cols), valid.clone()
    ex.eval_programs(progs, cols, valid)
    st = lattice.init_state(cspec, dev)
    sc = results["scatter_aggregate"]
    sc["ms_changelog"] = kernel_ms(
        lambda: lattice.scatter_step(cspec, st, -1, key, ts, valid, cols),
        30)[0]
    sc["ms_changelog_global"] = kernel_ms(
        lambda: lattice.scatter_step(cspec, st, -1, key, ts, valid, cols,
                                     mode=kb.SCATTER_GLOBAL), 30)[0]
    # its bound: per record four 4-byte columns (key, ts, temp, the
    # computed input) and four 1-byte ones (valid with the WHERE folded
    # in, three NULL masks) read once, and the state the data touches
    # read and written once: per cell count, touched, COUNT and SUM, and
    # 4 B per (cell, bin) hit
    cell = key.long() * cspec.n_slots + torch.remainder(
        torch.div(ts, 10_000, rounding_mode="floor"), cspec.n_slots).long()
    ok = valid & ~cols["__null_a2"] & torch.isfinite(cols["temp"])
    bins = quantile_bin(cols["temp"][ok], cspec.qcfg).long()
    n_bins = int(torch.unique(cell[ok] * cspec.qcfg.n_bins + bins).numel())
    n_cells = int(torch.unique(cell[valid]).numel())
    sc["bound_ms_changelog"], sc["bound_by_changelog"] = bound(
        BATCH * (4 * 4 + 1 + 3) + 2 * (n_cells * 13 + n_bins * 4),
        BATCH * 40)
    log(f"scatter_aggregate at the changelog path's shapes: "
        f"{sc['ms_changelog']:.4f} ms (first design "
        f"{SCATTER_RUN_K_MS['changelog']}, global branch "
        f"{sc['ms_changelog_global']:.4f}, bound "
        f"{sc['bound_ms_changelog']:.4f} by {sc['bound_by_changelog']})")


# ---- phase 6: the changelog path (EMIT CHANGES) -----------------------------

def np_quantile_bins(v: np.ndarray, cfg) -> tuple[np.ndarray, np.ndarray]:
    """numpy bins of float32 values (the reference's float32 formula) and,
    per value, whether it lies within one float32 ulp of a bin edge
    (where numpy's log may bin it one bucket away from the card's)."""
    f32 = np.float32
    lo, gl = f32(cfg.min_value), f32(cfg.gamma_log)
    x = np.maximum(v.astype(f32), f32(0))
    safe = np.maximum(x, lo)
    b = np.floor(np.log(safe / lo) / gl).astype(np.int64) + 1
    b = np.where(x < lo, 0, np.clip(b, 1, cfg.n_bins - 1))
    exact = np.log(safe.astype(np.float64) / float(lo)) / float(gl)
    edge = np.abs(exact - np.rint(exact)) <= 4 * np.spacing(
        np.abs(exact).astype(f32)).astype(np.float64)
    return b, edge & (x >= lo)


def np_quantile_estimate(hist: np.ndarray, q: float, cfg) -> np.ndarray:
    """The reference's quantile_estimate in numpy float32."""
    f32 = np.float32
    total = hist.sum(-1).astype(f32)
    cdf = np.cumsum(hist, -1).astype(f32)
    target = f32(q) * np.maximum(total, f32(1))
    idx = np.clip((cdf < target[..., None]).sum(-1), 0, cfg.n_bins - 1)
    mid = f32(cfg.min_value) * np.exp(
        (idx.astype(f32) - f32(1)) * f32(cfg.gamma_log)
        + f32(0.5 * cfg.gamma_log))
    return np.where(idx == 0, f32(0), mid).astype(f32), idx


def np_topk(v: np.ndarray, keys: np.ndarray, k: int, distinct: bool
            ) -> np.ndarray:
    """Per key, the k largest values (or k largest distinct), -inf
    padded: [N_KEYS, k] float32."""
    order = np.lexsort((-v, keys))
    ks, vs = keys[order], v[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    keep = first.copy() if distinct else None
    if distinct:
        keep[1:] |= vs[1:] != vs[:-1]
        ks, vs, first = ks[keep], vs[keep], first[keep]
    idx = np.arange(len(ks))
    start = np.maximum.accumulate(np.where(first, idx, 0))
    rank = idx - start
    out = np.full((N_KEYS, k), -np.inf, np.float32)
    sel = rank < k
    out[ks[sel], rank[sel]] = vs[sel]
    return out


def merge_topk(a: np.ndarray, b: np.ndarray, distinct: bool) -> np.ndarray:
    k = a.shape[1]
    comb = -np.sort(-np.concatenate([a, b], 1), 1)
    if distinct:
        dup = np.zeros_like(comb, bool)
        dup[:, 1:] = comb[:, 1:] == comb[:, :-1]
        comb = -np.sort(-np.where(dup, -np.inf, comb), 1)
    return comb[:, :k]


class ChangelogReference:
    """Per unique batch and key, what the changelog query aggregates:
    COUNT(temp), the f64 sum and sum|x| of temp*1.8+32 (float32 ops, as
    the expression kernel computes it), quantile bins, top-3 and top-3
    distinct, over the records with temp > 15 that are not NULL."""

    def __init__(self, src: "Batches", masks: list[np.ndarray], qcfg):
        f32 = np.float32
        self.parts = []
        self.edge_values = set()
        for kids, temps, null in zip(src.kids, src.temps, masks):
            ok = ~null & (temps > f32(15.0)) & np.isfinite(temps)
            k, t = kids[ok].astype(np.int64), temps[ok]
            v = (t * f32(1.8) + f32(32)).astype(np.float64)
            b, edge = np_quantile_bins(t, qcfg)
            self.edge_values |= set(np.unique(t[edge]).tolist())
            hist = np.bincount(k * qcfg.n_bins + b,
                               minlength=N_KEYS * qcfg.n_bins)
            self.parts.append(dict(
                count=np.bincount(k, minlength=N_KEYS),
                sum=np.bincount(k, weights=v, minlength=N_KEYS),
                abs=np.bincount(k, weights=np.abs(v), minlength=N_KEYS),
                hist=hist.reshape(N_KEYS, qcfg.n_bins),
                top=np_topk(t, k, TOPK_K, False),
                topd=np_topk(t, k, TOPK_K, True),
                edge=np.bincount(k[edge], minlength=N_KEYS)))


def check_changelog_rows(rows: list, ref: ChangelogReference, qcfg) -> dict:
    """Every changelog row against the running per-(key, window) values:
    batch b emits one row per key (every key is touched by every batch),
    for the window the batch lies in, with the values after batch b."""
    assert len(rows) == MAIN_BATCHES * N_KEYS, len(rows)
    size = 10_000
    mids = np_quantile_estimate(
        np.eye(qcfg.n_bins, dtype=np.int64), 1.0, qcfg)[0]
    acc = None
    q_off = q_edge_keys = 0
    for b in range(MAIN_BATCHES):
        part = ref.parts[b % N_UNIQUE]
        start = BASE_TS + (b * STREAM_MS_PER_BATCH) // size * size
        if acc is None or acc["start"] != start:
            acc = dict(start=start, count=0, sum=0.0, abs=0.0, hist=0,
                       edge=0,
                       top=np.full((N_KEYS, TOPK_K), -np.inf, np.float32),
                       topd=np.full((N_KEYS, TOPK_K), -np.inf, np.float32))
        for f in ("count", "sum", "abs", "hist", "edge"):
            acc[f] = acc[f] + part[f]
        acc["top"] = merge_topk(acc["top"], part["top"], False)
        acc["topd"] = merge_topk(acc["topd"], part["topd"], True)
        rs = rows[b * N_KEYS:(b + 1) * N_KEYS]
        keys = np.array([int(r["device"][1:]) for r in rs])
        assert sorted(keys.tolist()) == list(range(N_KEYS)), \
            f"batch {b}: changelog keys"
        assert all(r["winStart"] == start and r["winEnd"] == start + size
                   for r in rs), f"batch {b}: window bounds"
        c = np.array([r["c"] for r in rs])
        assert (c == acc["count"][keys]).all(), f"batch {b}: COUNT differs"
        s = np.array([r["s"] for r in rs])
        lim = 2 * acc["count"][keys] * U * acc["abs"][keys]
        assert (np.abs(s - acc["sum"][keys]) <= lim).all(), \
            f"batch {b}: SUM beyond the bound"
        for name, plane in (("t", acc["top"]), ("td", acc["topd"])):
            for r, kk in zip(rs, keys):
                want = [float(x) for x in plane[kk] if np.isfinite(x)]
                assert r[name] == want, f"batch {b}: {name} of key {kk}"
        # compared by bucket: the estimate is the bucket's midpoint, whose
        # expf may differ from numpy's exp by an ulp
        _, widx = np_quantile_estimate(acc["hist"][keys], 0.99, qcfg)
        got = np.array([r["q"] for r in rs], np.float32)
        gidx = np.abs(np.log(np.maximum(got, 1e-30))[:, None]
                      - np.log(np.maximum(mids, 1e-30))[None, :]).argmin(1)
        gidx = np.where(got == 0, 0, gidx)
        assert (np.abs(got - mids[gidx]) <= 2 * np.spacing(mids[gidx])
                ).all(), f"batch {b}: quantile not a bucket midpoint"
        off = gidx != widx
        if off.any():
            # one bucket apart, and only for a key whose data holds a
            # value within one ulp of a bin edge
            assert (np.abs(gidx[off] - widx[off]) == 1).all(), \
                f"batch {b}: quantile off by more than one bucket"
            assert (acc["edge"][keys][off] > 0).all(), \
                f"batch {b}: quantile differs away from a bin edge"
            q_off += int(off.sum())
        q_edge_keys = max(q_edge_keys, int((acc["edge"] > 0).sum()))
    return dict(quantile_rows_one_bucket_apart=q_off,
                edge_values=len(ref.edge_values),
                keys_holding_edge_values=q_edge_keys)


def changelog_path(dev) -> dict:
    """The changelog query at full width through IngestPipeline, deferred
    change decode and the async drain on, over the headline stream with a
    1 % NULL mask."""
    from hstream_tpu_torch.engine import IngestPipeline, QueryExecutor
    from hstream_tpu_torch.engine import codec_native

    node, schema, spec, _ = changelog_plan()
    ex = QueryExecutor(node, schema, emit_changes=True, initial_keys=1024,
                       batch_capacity=BATCH)
    assert ex.device == dev and ex.emit_changes
    ex.defer_change_decode = True
    ex.async_change_drain = True
    for k in range(N_KEYS):
        ex.key_id_for((f"d{k}",))
    src = Batches(seed=3)
    rng = np.random.default_rng(4)
    masks = [rng.random(BATCH) < NULL_RATE for _ in range(N_UNIQUE)]
    ref = ChangelogReference(src, masks, spec.qcfg)
    codec_native.load()
    pipe = IngestPipeline(ex, depth=4, workers=2)
    zero_counts()
    rows: list = []
    try:
        t0 = time.perf_counter()
        for b in range(MAIN_BATCHES):
            kids, ts, temps = src.get(b)
            rows.extend(pipe.submit(kids, ts, {"temp": temps},
                                    {"temp": masks[b % N_UNIQUE]}))
        rows.extend(pipe.flush())       # forces the change drain
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages = pipe.stats()
    finally:
        pipe.close()
    assert not ex.has_pending_changes()
    counts = launch_counts()
    stats = dict(ex.close_stats)
    for k in ("wire_decode", "expression", "scatter_aggregate", "topk_fold",
              "touched_extract"):
        assert counts[k] == MAIN_BATCHES, (k, counts)
    assert stats["close_cycles"] == stats["close_dispatches"] == \
        counts["reset_close"] == 2, (stats, counts)
    assert stats["close_fetches"] == 0 and counts["fused_close"] == 0, \
        (stats, counts)
    assert all(counts[k] == 0 for k in counts if k.startswith("session")), \
        counts
    quant = check_changelog_rows(rows, ref, spec.qcfg)
    profile = profile_changelog(ex, src, masks)
    return dict(config="changelog", events_per_sec=MAIN_BATCHES * BATCH / wall,
                wall_s=wall, rows=len(rows), close_stats=stats,
                launches=counts, transfer_stats=ex.transfer_stats,
                pipeline_stages=stages, quantile=quant, profile=profile)


PROFILE_BATCHES = 30
# device events of the changelog path, by the kernel wrapper they serve
_EVENT_KERNEL = {"decode_kernel": "wire_decode",
                 "expr_kernel": "expression",
                 "scatter_private": "scatter_aggregate",
                 "scatter_cluster": "scatter_aggregate",
                 "scatter_global": "scatter_aggregate",
                 "topk_kernel": "topk_fold",
                 "touched_": "touched_extract", "close_kernel": "close",
                 "Memcpy HtoD": "h2d_copy", "Memcpy DtoH": "d2h_copy"}


def profile_changelog(ex, src, masks) -> dict:
    """A steady-state window of the changelog path (the executor of the
    checked run, PROFILE_BATCHES further batches of the same stream, no
    window end) under torch.profiler: each kernel's device time per
    batch and the device's busy share of the window's wall time."""
    from hstream_tpu_torch.engine import IngestPipeline

    pipe = IngestPipeline(ex, depth=4, workers=2)

    def window():
        t0 = time.perf_counter()
        for b in range(MAIN_BATCHES, MAIN_BATCHES + PROFILE_BATCHES):
            kids, ts, temps = src.get(b)
            pipe.submit(kids, ts, {"temp": temps},
                        {"temp": masks[b % N_UNIQUE]})
        pipe.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    try:
        wall, dev = profiled(window)
    finally:
        pipe.close()
    per = {}
    for name, us in dev.items():
        k = next((v for e, v in _EVENT_KERNEL.items() if e in name), "other")
        per[k] = per.get(k, 0.0) + us / 1e3 / PROFILE_BATCHES
    busy = sum(dev.values()) / 1e6 / wall
    return dict(batches=PROFILE_BATCHES, wall_s=wall,
                events_per_sec=PROFILE_BATCHES * BATCH / wall,
                device_ms_per_batch=per, device_busy_share=busy)


# ---- phase 3 (sessions): the session kernels against their plain versions --

SESS_GAP = 5000


def session_spec_all():
    """Every session aggregate kind over a float, an int, a bool and a
    computed input; p50/p99 share one histogram plane."""
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import ColumnType, Schema
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.expr import BinOp, Col, Lit

    v, w, b = Col("v"), Col("w"), Col("b")
    aggs = (AggSpec(A.COUNT_ALL, "c"), AggSpec(A.COUNT, "n", input=v),
            AggSpec(A.SUM, "s", input=v), AggSpec(A.AVG, "a", input=v),
            AggSpec(A.MIN, "lo", input=v), AggSpec(A.MAX, "hi", input=v),
            AggSpec(A.APPROX_COUNT_DISTINCT, "d", input=v),
            AggSpec(A.APPROX_QUANTILE, "p50", input=v, quantile=0.5),
            AggSpec(A.APPROX_QUANTILE, "p99", input=v, quantile=0.99),
            AggSpec(A.COUNT, "nw", input=w), AggSpec(A.MIN, "wlo", input=w),
            AggSpec(A.MAX, "whi", input=w),
            AggSpec(A.SUM, "sx",
                    input=BinOp("+", BinOp("*", v, Lit(2.0)), w)),
            AggSpec(A.APPROX_COUNT_DISTINCT, "db", input=b),
            AggSpec(A.AVG, "ab", input=b))
    schema = Schema.of(v=ColumnType.FLOAT, w=ColumnType.INT,
                       b=ColumnType.BOOL)
    spec = sl.SessionSpec(aggs=aggs)
    layout = (("b", "bool"), ("v", "f32"), ("w", "i32"))
    return spec, schema, layout, sl.session_programs(spec, schema)


def session_batch(dev, spec, layout, seed: int, n: int, n_codes: int,
                  t_lo: int):
    """An awkward packed batch: out of order, consecutive records of a
    key exactly gap and gap + 1 apart, equal starts, invalid records,
    NULL masks, NaN, +-inf, +-0.0, int extremes."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_codes, n).astype(np.int64)
    steps = np.array([0, 0, 1, 7, SESS_GAP, SESS_GAP, SESS_GAP + 1,
                      SESS_GAP + 1, 3 * SESS_GAP], np.int64)
    # per key, in sorted position: a random start, then records the
    # chosen steps apart (equal, 1, 7, gap, gap + 1, 3 gap)
    order = np.argsort(codes, kind="stable")
    sc = codes[order]
    first = np.ones(n, bool)
    first[1:] = sc[1:] != sc[:-1]
    step = steps[rng.integers(0, len(steps), n)]
    step[first] = rng.integers(0, 4 * SESS_GAP, int(first.sum()))
    csum = np.cumsum(step)
    base = np.maximum.accumulate(np.where(first, csum - step, 0))
    ts = np.empty(n, np.int64)
    ts[order] = t_lo + csum - base
    perm = rng.permutation(n)                        # out of order
    return pack_session(dev, spec, layout, rng, codes[perm], ts[perm])


def pack_session(dev, spec, layout, rng, codes, ts, valid=None):
    """A packed batch of the given codes and times, with awkward values
    (NULL masks, NaN, +-inf, +-0.0, int extremes) and valid flags (2 %
    invalid unless given)."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.expr import columns_of

    n = len(codes)
    pool = np.array([1.5, -2.0, 0.0, -0.0, np.inf, -np.inf, np.nan, 1e30,
                     -1e30, 3.25, 1e-7, 7e8, 2e9], np.float32)
    v = (rng.normal(40, 25, n)).astype(np.float32)
    sel = rng.random(n) < 0.05
    v[sel] = pool[rng.integers(0, len(pool), int(sel.sum()))]
    w = rng.integers(-1000, 1000, n).astype(np.int32)
    w[::101] = np.iinfo(np.int32).max
    w[::103] = np.iinfo(np.int32).min
    bcol = rng.random(n) < 0.5
    drawn = rng.random(n) > 0.02
    valid = drawn if valid is None else valid
    nv, nw_, nb_ = (rng.random(n) < 0.03 for _ in range(3))
    masks = []
    for a in spec.aggs:
        if a.input is None:
            continue
        cs = columns_of(a.input)
        m = np.zeros(n, bool)
        m |= nv if "v" in cs else False
        m |= nw_ if "w" in cs else False
        m |= nb_ if "b" in cs else False
        masks.append(m)
    buf = sl.pack_batch_host(n, n, np.asarray(codes).astype(np.int32),
                             np.asarray(ts).astype(np.int32), valid,
                             {"v": v, "w": w, "b": bcol}, masks, layout)
    return torch.from_numpy(buf).to(dev)


def session_seg(dev, spec, seed: int, nseg: int, n_codes: int, t_lo: int):
    """Random segment planes in the arena's layout: sentinel pads,
    overlapping and gap-apart intervals, +-inf MIN/MAX identities,
    sparse HLL registers and histograms."""
    from hstream_tpu_torch.engine import AggKind as A
    from hstream_tpu_torch.engine import session_lattice as sl

    rng = np.random.default_rng(seed)
    seg = sl.session_plane_np(spec, nseg)
    seg["code"][:] = rng.integers(0, n_codes, nseg)
    seg["code"][rng.random(nseg) < 0.05] = sl.SESSION_SENT_CODE
    t0 = t_lo + rng.integers(0, 40 * SESS_GAP, nseg)
    seg["t0"][:] = t0
    seg["t1"][:] = t0 + rng.choice([0, 1, SESS_GAP, 2 * SESS_GAP], nseg)
    for _i, name, agg in sl._owners(spec):
        p = seg[name]
        if agg.kind in (A.COUNT_ALL, A.COUNT):
            p[:] = rng.integers(0, 50, nseg)
        elif agg.kind in (A.SUM, A.AVG):
            p[:] = rng.normal(0, 100, nseg)
            if agg.kind == A.AVG:
                seg[name + "_n"][:] = rng.integers(0, 50, nseg)
        elif agg.kind in (A.MIN, A.MAX):
            p[:] = rng.normal(0, 100, nseg)
            p[rng.random(nseg) < 0.1] = np.inf if agg.kind == A.MIN \
                else -np.inf
            p[rng.random(nseg) < 0.05] = -0.0
        elif agg.kind == A.APPROX_COUNT_DISTINCT:
            hit = rng.random(p.shape) < 0.02
            p[hit] = rng.integers(1, 23, int(hit.sum()))
        else:
            hit = rng.random(p.shape) < 0.05
            p[hit] = rng.integers(1, 9, int(hit.sum()))
    return {k: torch.from_numpy(v).to(dev) for k, v in seg.items()}


def _abs_planes(spec, arena):
    """The arena with its SUM/AVG planes made |x| (for the order bound)."""
    from hstream_tpu_torch.engine import AggKind as A
    from hstream_tpu_torch.engine import session_lattice as sl

    out = {k: v.clone() for k, v in arena.items()}
    for _i, name, agg in sl._owners(spec):
        if agg.kind in (A.SUM, A.AVG):
            out[name] = out[name].abs()
    return out


def check_session_arenas(spec, got, want, terms, absw, what) -> float:
    """got vs want: code, t0, t1, integer planes, HLL and histograms
    exact, MIN/MAX by value, SUM/AVG within 2*n*2^-24*sum|x| per slot
    (n the slot's folded terms); returns the largest SUM/AVG error."""
    from hstream_tpu_torch.engine import AggKind as A
    from hstream_tpu_torch.engine import session_lattice as sl

    sums = {name for _i, name, agg in sl._owners(spec)
            if agg.kind in (A.SUM, A.AVG)}
    err = 0.0
    for k in want:
        a, b = got[k], want[k]
        if k in sums:
            d = (a.double() - b.double()).abs()
            lim = 2 * terms.double() * U * absw[k].double() + 1e-30
            bad = int((d > lim).sum())
            worst = float(d.max()) if d.numel() else 0.0
            assert bad == 0, f"{what}: {k} beyond the order bound " \
                f"({bad} slots, max err {worst})"
            err = max(err, worst)
        elif k.endswith(("_min", "_max")):
            assert torch.equal(a, b), f"{what}: {k} differs"
        else:
            assert same_bits(a, b, k), f"{what}: {k} differs"
    return err


def _terms(dest: torch.Tensor, cap: int) -> torch.Tensor:
    d = dest[dest < cap]
    return torch.bincount(d, minlength=cap)[:cap]


def step_vs_plain(spec, arena, packed, inputs, gap, close_cut, delta,
                  what):
    """The step kernel and its plain version on the same inputs, each
    into its own fresh arena; asserts they agree (check_session_arenas)
    and returns (largest SUM/AVG error, the plain version's arena)."""
    from hstream_tpu_torch.engine import session_lattice as sl

    dev, cap = arena["code"].device, arena["code"].shape[0]
    before = sl.session_step.launches
    got = sl.init_session_arena(spec, cap, dev)
    sl.session_step(spec, arena, got, packed, inputs, gap, close_cut, delta)
    assert sl.session_step.launches == before + 1
    want = sl.init_session_arena(spec, cap, dev)
    sl.session_step_ref(spec, arena, want, packed, inputs, gap, close_cut,
                        delta)
    absw = sl.init_session_arena(spec, cap, dev)
    sl.session_step_ref(spec, _abs_planes(spec, arena), absw, packed,
                        tuple(None if x is None else
                              (x.abs() if x.dtype == torch.float32 else x)
                              for x in inputs),
                        gap, close_cut, delta)
    acode, at0, at1 = sl._retired(arena, close_cut, delta)
    valid = (packed[2] & 1) != 0
    bcode = torch.where(valid, packed[0].long(), sl.SESSION_SENT_CODE)
    ts = packed[1].long()
    dest = sl.chain_slots(torch.cat([acode, bcode]), torch.cat([at0, ts]),
                          torch.cat([at1, ts]), gap, cap)
    torch.cuda.synchronize()
    err = check_session_arenas(spec, got, want, _terms(dest, cap), absw,
                               what)
    return err, want


def merge_vs_plain(spec, arena, seg, gap, close_cut, delta, what):
    """The merge kernel and its plain version on the same inputs, each
    into its own fresh arena; asserts they agree and returns (largest
    SUM/AVG error, the plain version's arena)."""
    from hstream_tpu_torch.engine import session_lattice as sl

    dev, cap = arena["code"].device, arena["code"].shape[0]
    before = sl.session_merge.launches
    got = sl.init_session_arena(spec, cap, dev)
    sl.session_merge(spec, arena, got, seg, gap, close_cut, delta)
    assert sl.session_merge.launches == before + 1
    want = sl.init_session_arena(spec, cap, dev)
    sl.session_merge_ref(spec, arena, want, seg, gap, close_cut, delta)
    absw = sl.init_session_arena(spec, cap, dev)
    sl.session_merge_ref(spec, _abs_planes(spec, arena), absw,
                         _abs_planes(spec, seg), gap, close_cut, delta)
    acode, at0, at1 = sl._retired(arena, close_cut, delta)
    dest = sl.chain_slots(torch.cat([acode, seg["code"].long()]),
                          torch.cat([at0, seg["t0"].long()]),
                          torch.cat([at1, seg["t1"].long()]), gap, cap)
    torch.cuda.synchronize()
    err = check_session_arenas(spec, got, want, _terms(dest, cap), absw,
                               what)
    return err, want


def check_session_step(dev, results):
    """B11 on awkward inputs: an arena made by the plain step from a first
    batch, then evicted (sentinel) and retired (t1 <= close_cut) entries
    between live ones, a non-zero delta, and a second batch."""
    from hstream_tpu_torch.engine import session_lattice as sl

    spec, _schema, layout, progs = session_spec_all()
    cap, n = 1 << 16, 1 << 16
    arena = sl.init_session_arena(spec, cap, dev)
    p1 = session_batch(dev, spec, layout, 60, n, 400, 0)
    base = sl.init_session_arena(spec, cap, dev)
    sl.session_step_ref(spec, arena, base,
                        p1, sl.session_inputs(spec, layout, p1, progs),
                        SESS_GAP, -(1 << 30), 0)
    rng = np.random.default_rng(61)
    live = (base["code"] < sl.SESSION_SENT_CODE).cpu().numpy()
    hole = np.nonzero(live & (rng.random(cap) < 0.05))[0]
    base["code"][torch.from_numpy(hole).to(dev)] = sl.SESSION_SENT_CODE
    t1 = torch.sort(base["t1"][torch.from_numpy(live).to(dev)]).values
    close_cut = int(t1[len(t1) // 5])     # an entry's own t1: retired
    delta = 1234
    p2 = session_batch(dev, spec, layout, 62, n, 400, 30 * SESS_GAP)
    inputs = sl.session_inputs(spec, layout, p2, progs)
    err, want = step_vs_plain(spec, base, p2, inputs, SESS_GAP, close_cut,
                              delta, "session_step")
    retired = int(((base["code"] < sl.SESSION_SENT_CODE)
                   & (base["t1"] <= close_cut)).sum())
    n_live = int((want["code"] < sl.SESSION_SENT_CODE).sum())
    edges = []
    for name, arena_e, packed_e, cut_e, delta_e in session_edge_cases(
            dev, spec, layout, progs):
        e, want_e = step_vs_plain(
            spec, arena_e, packed_e,
            sl.session_inputs(spec, layout, packed_e, progs), SESS_GAP,
            cut_e, delta_e, f"session_step ({name})")
        err = max(err, e)
        edges.append(f"{name}: {int((want_e['code'] < sl.SESSION_SENT_CODE).sum())}"
                     f" sessions")
    results["session_step"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/session_step.cu",
        replaces="hstream_tpu/engine/lattice.py:1327",
        max_abs_err=err)
    log(f"session_step: every aggregate kind, {len(hole)} evicted and "
        f"{retired} retired arena entries, delta {delta}, {n} records "
        f"(out of order, gap/gap+1 apart, equal starts, NULLs, NaN, "
        f"+-inf, +-0.0) -> {n_live} sessions; {'; '.join(edges)}: exact, "
        f"SUM/AVG within their bound (max err {err:.3g})")


def session_edge_cases(dev, spec, layout, progs):
    """(name, arena, packed batch, close_cut, delta) of the sort's and
    the fold's edge cases: keys all in one bucket (no pass runs) or
    differing in the low byte only (one pass runs); codes at 2^22 - 1
    beside sentinels, codes >= 2^22 and negative codes; starts on both
    sides of the int32 wrap, shifted across it; m below one tile; an
    arena of no slots; a batch of no records. Arenas come from the plain
    step over a first batch."""
    from hstream_tpu_torch.engine import session_lattice as sl

    rng = np.random.default_rng(64)
    i32 = np.iinfo(np.int32)
    sent = sl.SESSION_SENT_CODE

    def arena_of(cap, codes, ts):
        empty = sl.init_session_arena(spec, cap, dev)
        out = sl.init_session_arena(spec, cap, dev)
        p = pack_session(dev, spec, layout, rng, codes, ts)
        sl.session_step_ref(spec, empty, out, p,
                            sl.session_inputs(spec, layout, p, progs),
                            SESS_GAP, -(1 << 30), 0)
        return out

    def one_code(cap, starts):
        # every slot live under code 5: no sentinel key in the sort
        arena = arena_of(cap, rng.integers(0, 300, 3000),
                         rng.integers(0, 30 * SESS_GAP, 3000))
        arena["code"].fill_(5)
        arena["t0"].copy_(torch.from_numpy(starts.astype(np.int32)))
        arena["t1"].copy_(arena["t0"])
        return arena

    n = 5000
    ones = np.ones(n, bool)
    yield ("one bucket", one_code(64, np.full(64, 1000)),
           pack_session(dev, spec, layout, rng, np.full(n, 5),
                        np.full(n, 1000), ones), -(1 << 30), 0)
    yield ("low byte only", one_code(256, 1000 + np.arange(256)),
           pack_session(dev, spec, layout, rng, np.full(n, 5),
                        1000 + rng.integers(0, 256, n), ones), -(1 << 30), 0)
    top = [sent - 1, sent - 2, sent - 3] + list(range(20))
    arena = arena_of(2048, rng.choice(top, 1500),
                     rng.integers(0, 200 * SESS_GAP, 1500))
    arena["code"][::7] = sent
    codes = rng.choice(top + [sent, sent + 5, -1], n)
    yield ("codes 2^22 - 1 beside sentinels", arena,
           pack_session(dev, spec, layout, rng, codes,
                        rng.integers(0, 250 * SESS_GAP, n)), SESS_GAP, 0)
    lo, hi = int(i32.min), int(i32.max)
    wrap_ts = np.where(rng.random(1500) < 0.5,
                       rng.integers(hi - 6 * SESS_GAP, hi, 1500),
                       rng.integers(lo, lo + 6 * SESS_GAP, 1500))
    arena = arena_of(2048, rng.integers(0, 40, 1500), wrap_ts)
    wrap_b = np.where(rng.random(n) < 0.5,
                      rng.integers(hi - 8 * SESS_GAP, hi, n),
                      rng.integers(lo, lo + 8 * SESS_GAP, n))
    yield ("starts across the int32 wrap", arena,
           pack_session(dev, spec, layout, rng, rng.integers(0, 40, n),
                        wrap_b), lo + 2 * SESS_GAP, -3 * SESS_GAP)
    arena = arena_of(100, rng.integers(0, 30, 80),
                     rng.integers(0, 10 * SESS_GAP, 80))
    yield ("m below one tile", arena,
           pack_session(dev, spec, layout, rng, rng.integers(0, 30, 200),
                        rng.integers(0, 12 * SESS_GAP, 200)), 0, 7)
    yield ("cap = 0", sl.init_session_arena(spec, 0, dev),
           session_batch(dev, spec, layout, 65, 3000, 300, 0), 0, 0)
    arena = arena_of(4096, rng.integers(0, 300, 3000),
                     rng.integers(0, 30 * SESS_GAP, 3000))
    yield ("nb = 0", arena,
           pack_session(dev, spec, layout, rng, np.zeros(0, np.int64),
                        np.zeros(0, np.int64)), 5 * SESS_GAP, 11)
    arena, codes, ts = tie_wrap(spec, 4096, dev, rng, 40, n)
    yield ("ties at the int32 wrap", arena,
           pack_session(dev, spec, layout, rng, codes, ts), -(1 << 30), 0)


def tie_wrap_times(rng, m: int):
    """(starts, ends) int64 of m entries near the int32 wrap: starts from
    a few values within 2 gaps of 2^31 - 1 (so equal starts are common),
    ends at, a little past, or a gap past their start, wrapped as int32
    (a running end + gap then wraps in the break test)."""
    hi = int(np.iinfo(np.int32).max)
    starts = hi - rng.choice(np.arange(60, 2 * SESS_GAP, 97), m)
    ends = starts + rng.choice([0, 0, 40, SESS_GAP // 2, SESS_GAP + 7], m)
    return starts, ((ends + 2**31) % 2**32) - 2**31


def tie_wrap(spec, cap: int, dev, rng, n_codes: int, n: int, S: int = 1,
             s: int = 0):
    """An arena (codes of shard s of S) whose live rows sit at the int32
    wrap with equal starts (tie_wrap_times), and a batch's codes and
    times repeating those starts: equal (code, start) entries whose
    order decides the chains (the reference takes them by end)."""
    from hstream_tpu_torch.engine import session_lattice as sl

    arena = random_arena(spec, cap, dev, int(rng.integers(1 << 30)))
    live = cap // 2
    code = np.full(cap, sl.SESSION_SENT_CODE, np.int64)
    code[:live] = rng.integers(0, n_codes, live) * S + s
    t0, t1 = tie_wrap_times(rng, live)
    for k, v in (("code", code), ("t0", np.r_[t0, np.zeros(cap - live)]),
                 ("t1", np.r_[t1, np.zeros(cap - live)])):
        arena[k].copy_(torch.from_numpy(v.astype(np.int32)))
    codes = rng.integers(0, n_codes * S, n)
    ts = np.where(rng.random(n) < 0.5, rng.choice(t0, n),
                  tie_wrap_times(rng, n)[0])
    return arena, codes, ts


def check_session_merge(dev, results):
    """B12: the same arena shape merged with random segment planes."""
    from hstream_tpu_torch.engine import session_lattice as sl

    spec, _schema, layout, _progs = session_spec_all()
    cap, nseg = 1 << 14, 5000
    empty = sl.init_session_arena(spec, cap, dev)
    base = sl.init_session_arena(spec, cap, dev)
    sl.session_merge_ref(spec, empty, base,
                         session_seg(dev, spec, 70, 3000, 500, 0),
                         SESS_GAP, -(1 << 30), 0)
    base["code"][::37] = sl.SESSION_SENT_CODE
    close_cut, delta = 15 * SESS_GAP, 777
    seg = session_seg(dev, spec, 71, nseg, 500, 10 * SESS_GAP)
    err, _want = merge_vs_plain(spec, base, seg, SESS_GAP, close_cut, delta,
                                "session_merge")
    # the shared core's edge cases: no arena slots, no segments, m below
    # one tile, every key in one bucket
    small = sl.init_session_arena(spec, 64, dev)
    sl.session_merge_ref(spec, sl.init_session_arena(spec, 64, dev), small,
                         session_seg(dev, spec, 72, 40, 20, 0), SESS_GAP,
                         -(1 << 30), 0)
    one = session_seg(dev, spec, 74, 3000, 1, 0)
    one["code"].fill_(3)
    one["t0"].fill_(500)
    one["t1"].fill_(500)
    tie_arena, tie_seg = tie_wrap_seg(spec, 4096, 3000, dev, 77)
    for name, arena_e, seg_e, cut_e, delta_e in (
            ("cap = 0", sl.init_session_arena(spec, 0, dev),
             session_seg(dev, spec, 73, 3000, 200, 0), close_cut, delta),
            ("no segments", base, session_seg(dev, spec, 75, 0, 1, 0),
             close_cut, delta),
            ("m below one tile", small,
             session_seg(dev, spec, 76, 100, 20, 2 * SESS_GAP), close_cut,
             delta),
            ("one bucket", sl.init_session_arena(spec, 0, dev), one,
             close_cut, delta),
            ("ties at the int32 wrap", tie_arena, tie_seg, -(1 << 30), 0)):
        e, _w = merge_vs_plain(spec, arena_e, seg_e, SESS_GAP, cut_e,
                               delta_e, f"session_merge ({name})")
        err = max(err, e)
    results["session_merge"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/session_merge.cu",
        replaces="hstream_tpu/engine/lattice.py:1432",
        max_abs_err=err)
    log(f"session_merge: {nseg} segments (sentinel pads, +-inf and -0.0 "
        f"MIN/MAX) into an arena with evicted and retired entries, delta "
        f"{delta}; no arena slots, no segments, m below one tile, one "
        f"bucket, ties at the int32 wrap: exact, SUM/AVG within their "
        f"bound (max err {err:.3g})")


def tie_wrap_seg(spec, cap: int, nseg: int, dev, seed: int, S: int = 1,
                 s: int = 0, n_codes: int = 40):
    """tie_wrap's arena and segments at the same starts (tie_wrap_times):
    a segment-mode batch of equal (code, start) entries at the wrap."""
    rng = np.random.default_rng(seed)
    arena, _codes, _ts = tie_wrap(spec, cap, dev, rng, n_codes, 0, S, s)
    seg = session_seg(dev, spec, seed + 1, nseg, n_codes * S, 0)
    t0 = arena["t0"][:cap // 2].cpu().numpy().astype(np.int64)
    st = np.where(rng.random(nseg) < 0.5, rng.choice(t0, nseg),
                  tie_wrap_times(rng, nseg)[0])
    en = st + rng.choice([0, 40, SESS_GAP + 7], nseg)
    for k, v in (("t0", st), ("t1", ((en + 2**31) % 2**32) - 2**31)):
        seg[k].copy_(torch.from_numpy(v.astype(np.int32)))
    return arena, seg


def check_session_extract(dev, results):
    """B13: -1 pads, empty histograms, HLL estimates near .5, +-inf
    MIN/MAX, AVG with n = 0; every row bit-exact."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.lattice import pad_slots
    from hstream_tpu_torch.engine.sketches import hll_estimate

    spec, _schema, _layout, _progs = session_spec_all()
    cap = 1 << 12
    seg = session_seg(dev, spec, 80, cap, 1 << 20, 0)
    arena = {k: v.clone() for k, v in seg.items()}
    arena["code"].copy_(torch.arange(cap, dtype=torch.int32, device=dev))
    rng = np.random.default_rng(81)
    regs = arena["a6_approx_count_distinct"]
    fill = torch.from_numpy(rng.random(cap)).to(dev)[:, None]
    regs.copy_(torch.where(torch.rand(regs.shape, device=dev) < fill,
                           torch.randint(1, 12, regs.shape, device=dev,
                                         dtype=torch.int8),
                           torch.zeros_like(regs)))
    est = hll_estimate(regs, spec.hll).double()
    frac = (est - est.floor() - 0.5).abs().cpu().numpy()
    near = np.argsort(frac)[:64]
    empty = rng.choice(cap, 64, replace=False)
    arena["a7_approx_quantile"][torch.from_numpy(empty).to(dev)] = 0
    arena["a3_avg_n"][::5] = 0
    pick = np.unique(np.concatenate([near, empty, rng.choice(cap, 700)]))
    slots = pad_slots(rng.permutation(pick).astype(np.int32))
    before = sl.session_extract.launches
    got = sl.session_extract(spec, arena, slots)
    assert sl.session_extract.launches == before + 1
    want = sl.session_extract_ref(spec, arena,
                                  torch.from_numpy(slots).to(dev))
    torch.cuda.synchronize()
    assert (slots < 0).any(), "no pad in the slot vector"
    assert torch.equal(got, want), "session_extract differs"
    # config 4's spec (p50 and p99 on one histogram), every kind at HLL
    # p 4, 10 and 14, and nine quantiles on one histogram among 20
    # aggregates (three passes over it); random arenas of 2^14 slots,
    # vectors of one slot and of 8,192 (6,250 or 8,000 named, the rest
    # pads: the slots by value in the launch, or uploaded)
    cases = 0
    for name, sp in session_extract_specs().items():
        arena = random_arena(sp, 1 << 14, dev, 90 + cases)
        for n_live in (1, 6250, 8000):   # 8000: past the by-value slots
            sel = pad_slots(rng.choice(1 << 14, n_live, replace=False)
                            .astype(np.int32))
            got = sl.session_extract(sp, arena, sel)
            want = sl.session_extract_ref(sp, arena,
                                          torch.from_numpy(sel).to(dev))
            torch.cuda.synchronize()
            assert torch.equal(got, want), \
                f"session_extract {name} P={len(sel)} differs"
            cases += 1
    results["session_extract"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/session_extract.cu",
        replaces="hstream_tpu/engine/lattice.py:1504",
        max_abs_err=0.0)
    log(f"session_extract: {len(pick)} slots + {int((slots < 0).sum())} "
        f"pads, 64 empty histograms, HLL estimates within "
        f"{float(frac[near].max()):.2g} of .5, +-inf MIN/MAX, AVG n = 0: "
        f"bit-exact; {cases} more (config 4, every kind at HLL p 4 / 10 "
        f"/ 14, nine quantiles on one histogram; P 1 and 8192 with 6250 "
        f"and 8000 named): bit-exact")


def session_extract_specs() -> dict:
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.expr import Col
    from hstream_tpu_torch.engine.sketches import HLLConfig

    every = session_spec_all()[0]
    out = {"config 4": sl.SessionSpec(aggs=tuple(session_plan()[0].aggs))}
    for p in (4, 10, 14):
        out[f"every kind, p {p}"] = sl.SessionSpec(aggs=every.aggs,
                                                   hll=HLLConfig(p))
    v = Col("v")
    qs = [AggSpec(A.APPROX_QUANTILE, f"q{k}", input=v, quantile=k / 10)
          for k in range(1, 10)]
    out["nine quantiles"] = sl.SessionSpec(aggs=tuple(
        qs[:4] + list(every.aggs[:6]) + qs[4:] + [every.aggs[6]]))
    return out


def random_arena(spec, cap: int, dev, seed: int) -> dict:
    """An arena of `cap` slots drawn at random: codes (some sentinels),
    counts, sums, AVG counts (some 0), MIN/MAX with their +-inf
    identities and -0.0, HLL ranks up to 33 - p, sparse histograms (some
    empty, some large)."""
    from hstream_tpu_torch.engine import AggKind as A
    from hstream_tpu_torch.engine import session_lattice as sl

    rng = np.random.default_rng(seed)
    ar = sl.session_plane_np(spec, cap)
    ar["code"][:] = rng.integers(0, 1 << 20, cap)
    ar["code"][rng.random(cap) < 0.05] = sl.SESSION_SENT_CODE
    ar["t0"][:] = rng.integers(0, 1 << 20, cap)
    ar["t1"][:] = ar["t0"] + rng.integers(0, 9000, cap)
    for _i, name, agg in sl._owners(spec):
        p = ar[name]
        if agg.kind in (A.COUNT_ALL, A.COUNT):
            p[:] = rng.integers(0, 50, p.shape)
        elif agg.kind in (A.SUM, A.AVG):
            p[:] = rng.normal(0, 100, p.shape)
            if agg.kind == A.AVG:
                ar[name + "_n"][:] = np.where(rng.random(cap) < 0.2, 0,
                                              rng.integers(1, 50, cap))
        elif agg.kind in (A.MIN, A.MAX):
            p[:] = rng.normal(0, 100, p.shape)
            p[rng.random(p.shape) < 0.1] = np.inf if agg.kind == A.MIN \
                else -np.inf
            p[rng.random(p.shape) < 0.05] = -0.0
        elif agg.kind == A.APPROX_COUNT_DISTINCT:
            hit = rng.random(p.shape) < rng.random(cap)[:, None]
            p[:] = np.where(hit, rng.integers(
                1, spec.hll.max_rank + 1, p.shape), 0)
        else:
            hit = rng.random(p.shape) < 0.05
            p[:] = np.where(hit, rng.integers(1, 9, p.shape), 0)
            p[rng.random(cap) < 0.1] = 0
            p[rng.random(cap) < 0.02, int(rng.integers(0, p.shape[1]))] = \
                1 << 25   # totals past 2^24
    return {k: torch.from_numpy(x).to(dev) for k, x in ar.items()}


def check_session_remap(dev, results):
    """B14: codes below, at and above lcap, the sentinel, a table that
    evicts (maps to the sentinel)."""
    from hstream_tpu_torch.engine import session_lattice as sl

    rng = np.random.default_rng(90)
    cap, lcap = 1 << 12, 1024
    code = rng.integers(0, 2 * lcap, cap).astype(np.int32)
    code[::7] = lcap
    code[::11] = sl.SESSION_SENT_CODE
    lut = rng.permutation(lcap).astype(np.int32)
    lut[rng.random(lcap) < 0.2] = sl.SESSION_SENT_CODE
    a = {"code": torch.from_numpy(code).to(dev)}
    b = {"code": a["code"].clone()}
    lut_t = torch.from_numpy(lut).to(dev)
    before = sl.session_remap.launches
    sl.session_remap(a, lut_t)
    assert sl.session_remap.launches == before + 1
    sl.session_remap_ref(b, lut_t)
    torch.cuda.synchronize()
    assert torch.equal(a["code"], b["code"]), "session_remap differs"
    # the session arena's 2^17 and the join store's 2^21, each also with
    # a tail (a cap off a multiple of four) and on a base 4, 8 and 12
    # bytes past a 16-byte boundary (a view into a larger plane); the
    # sentinel flag both ways
    cases = 0
    for cap, lcap in ((1 << 17, 1 << 16), (1 << 21, 1 << 20)):
        for tail in (0, 3):
            for off in (0, 1, 2, 3):
                c = cap + tail
                buf = torch.from_numpy(rng.integers(
                    0, 2 * lcap, c + off).astype(np.int32)).to(dev)
                buf[off::9] = lcap
                buf[off + 1::13] = sl.SESSION_SENT_CODE
                lut = torch.from_numpy(np.sort(rng.choice(
                    4 * lcap, lcap, replace=False)).astype(np.int32)).to(dev)
                for flag in (False, True):
                    a = {"code": buf[off:].clone() if off == 0
                         else buf.clone()[off:]}
                    b = {"code": buf[off:].clone()}
                    assert a["code"].is_contiguous()
                    sl.session_remap(a, lut, sent_above=flag)
                    sl.session_remap_ref(b, lut, sent_above=flag)
                    torch.cuda.synchronize()
                    assert torch.equal(a["code"], b["code"]), \
                        f"session_remap differs: cap {c}, offset {off}, " \
                        f"sent_above {flag}"
                    cases += 1
    # timed at the join store's shape, with the sentinel flag (the
    # join's code remap); the session arena's shape is timed at the
    # path's own codes (time_session_kernels)
    cap, lcap = 1 << 21, 1 << 20
    code = {"code": torch.from_numpy(np.sort(rng.integers(
        0, 2 * lcap, cap)).astype(np.int32)).to(dev)}
    lut = torch.from_numpy(np.cumsum(rng.random(lcap) < 0.7)
                           .astype(np.int32)).to(dev)
    probe = {"code": code["code"].clone()}
    ms, call, src = kernel_ms(
        lambda: sl.session_remap(probe, lut, sent_above=True), 100)
    plain = kernel_ms(
        lambda: sl.session_remap_ref(probe, lut, sent_above=True), 20)[0]
    c = probe["code"]
    lib = kernel_ms(lambda: lut[c.clamp(0, lcap - 1).long()], 20)[0]
    b_ms, b_by = bound(2 * cap * 4 + lcap * 4, cap)
    # back to back, the 8 MiB plane and its 4 MiB table stay in the 50 MB
    # L2; the join remaps a store once, after other work: cold, each call
    # after a 64 MiB write that evicts them (the remap kernel's own
    # events only), at 2^21 codes and at phase 8's 2^22 store slots
    # (half of them the sentinel)
    flush = torch.empty(1 << 24, dtype=torch.int32, device=dev)
    cold = {}
    for n_cap in (cap, 2 * cap):
        c = np.full(n_cap, JOIN_SENT, np.int32)
        c[:cap] = np.sort(rng.integers(0, 2 * lcap, cap))
        st = {"code": torch.from_numpy(c).to(dev)}
        cold[n_cap] = kernel_only_ms(
            lambda: (flush.fill_(n_cap),
                     sl.session_remap(st, lut, sent_above=True)),
            50, "remap_kernel")
    results["session_remap"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/session_remap.cu",
        replaces="hstream_tpu/engine/lattice.py:1553",
        max_abs_err=0.0, ms_join=ms, call_ms_join=call, ms_source_join=src,
        plain_ms_join=plain, library_ms_join=lib, bound_ms_join=b_ms,
        bound_by_join=b_by, cap_join=cap, lcap_join=lcap,
        ms_join_cold=cold[cap], ms_join_store_cold=cold[2 * cap],
        bound_ms_join_store=bound(2 * 2 * cap * 4 + lcap * 4, 2 * cap)[0])
    log(f"session_remap: codes below, at and above lcap and the sentinel, "
        f"an evicting table; {cases} plane cases at 2^17 and 2^21 codes "
        f"(tails of 0 and 3, bases 0-12 bytes off 16, the sentinel flag "
        f"both ways): exact; at the join store's {cap} codes "
        f"(sent_above) {ms:.5f} ms (plain {plain:.4f}, indexing {lib:.4f}, "
        f"bound {b_ms:.5f} by {b_by}, {100 * b_ms / ms:.0f} % of it; the "
        f"plane in L2); cold {cold[cap]:.5f} ms, and {cold[2 * cap]:.5f} at "
        f"phase 8's {2 * cap} store slots")


# ---- phase 7: the session path (BASELINE config 4) --------------------------

SESS_USERS = 100_000
SESS_BATCHES = 48
SESS_SEG_BATCHES = 12
SESS_DRAIN_EVERY = 8
SESS_PROFILE_BATCHES = 8


def session_plan():
    """bench.py:340-356: SELECT user, APPROX_QUANTILE(lat, 0.5) AS p50,
    APPROX_QUANTILE(lat, 0.99) AS p99 FROM s GROUP BY user, SESSION(5 s),
    grace 0."""
    from hstream_tpu_torch.engine import (
        AggKind as A, AggregateNode, AggSpec, ColumnType, Schema,
        SessionWindow, SourceNode)
    from hstream_tpu_torch.engine.expr import Col

    schema = Schema.of(user=ColumnType.STRING, lat=ColumnType.FLOAT)
    node = AggregateNode(
        child=SourceNode("s", schema), group_keys=[Col("user")],
        window=SessionWindow(SESS_GAP, grace_ms=0),
        aggs=[AggSpec(A.APPROX_QUANTILE, "p50", input=Col("lat"),
                      quantile=0.5),
              AggSpec(A.APPROX_QUANTILE, "p99", input=Col("lat"),
                      quantile=0.99)])
    return node, schema


class SessionStream:
    """The session path's stream from a seed: batch b covers stream ms
    [BASE + 1000 b, + 1000), shuffled; user slot s is active in batch b
    iff (b + s) mod 16 < 8 and takes a fresh user id with probability
    3/4 at the start of each on-phase; lat = |normal(50, 20)|."""

    def __init__(self, seed: int, n_batches: int, users: int = SESS_USERS):
        rng = np.random.default_rng(seed)
        slots = np.arange(users)
        ids = slots.copy()
        nxt = users
        self.uids, self.ts, self.lats = [], [], []
        for b in range(n_batches):
            start = (b + slots) % 16 == 0
            fresh = start & (rng.random(users) < 0.75) & (b > 0)
            k = int(fresh.sum())
            ids[fresh] = np.arange(nxt, nxt + k)
            nxt += k
            active = slots[(b + slots) % 16 < 8]
            self.uids.append(ids[active[rng.integers(0, len(active),
                                                     BATCH)]])
            self.ts.append(BASE_TS + 1000 * b
                           + rng.integers(0, 1000, BATCH))
            self.lats.append(np.abs(rng.normal(50, 20, BATCH))
                             .astype(np.float32))
        self.names = np.char.add("u", np.char.zfill(
            np.arange(nxt).astype(str), 7))

    def get(self, b: int):
        return self.ts[b], {"user": self.names[self.uids[b]],
                            "lat": self.lats[b]}


def session_reference(src: SessionStream, n_batches: int, qcfg):
    """numpy: per user id, records sorted by ts, split where the gap
    exceeds 5000 ms; a session closes once the watermark (the last
    batch's max ts) reaches t1 + 10000. Per closed session: the user,
    t0, t1 and the p50/p99 bucket of its lat values, and whether it holds
    a value within one float32 ulp of a bin edge."""
    uid = np.concatenate(src.uids[:n_batches]).astype(np.int64)
    ts = np.concatenate(src.ts[:n_batches]).astype(np.int64)
    lat = np.concatenate(src.lats[:n_batches])
    wm = int(ts.max())
    order = np.argsort(uid * (1 << 20) + (ts - BASE_TS), kind="stable")
    u, t = uid[order], ts[order]
    brk = np.ones(len(u), bool)
    brk[1:] = (u[1:] != u[:-1]) | (t[1:] - t[:-1] > SESS_GAP)
    sid = np.cumsum(brk) - 1
    starts = np.nonzero(brk)[0]
    ends = np.append(starts[1:], len(u)) - 1
    t0, t1 = t[starts], t[ends]
    closed = t1 + 2 * SESS_GAP <= wm
    bins, edge = np_quantile_bins(lat[order], qcfg)
    counts = ends - starts + 1
    srt = np.argsort(sid * qcfg.n_bins + bins, kind="stable")
    sb = bins[srt]
    out = {}
    for q in (0.5, 0.99):
        target = np.float32(q) * counts.astype(np.float32)
        k = np.ceil(target.astype(np.float64)).astype(np.int64)
        out[q] = sb[starts + np.maximum(k, 1) - 1]
    has_edge = np.bincount(sid[edge], minlength=len(starts)) > 0
    c = closed
    return dict(user=src.names[u[starts][c]], t0=t0[c], t1=t1[c],
                b50=out[0.5][c], b99=out[0.99][c], edge=has_edge[c],
                open=int((~closed).sum()), wm=wm)


def check_session_rows(rows, ref, qcfg) -> dict:
    """Every emitted row against the reference: the same set of (user,
    winStart), winEnd = t1 + gap, p50/p99 in the reference's bucket (one
    bucket apart only for a session holding a bin-edge value)."""
    n = len(ref["user"])
    assert len(rows) == n, f"session rows: {len(rows)} != {n}"
    users = np.array([r["user"] for r in rows])
    w0 = np.array([r["winStart"] for r in rows], np.int64)
    w1 = np.array([r["winEnd"] for r in rows], np.int64)
    got = np.lexsort((w0, users))
    want = np.lexsort((ref["t0"], ref["user"]))
    assert (users[got] == ref["user"][want]).all(), "session users differ"
    assert (w0[got] == ref["t0"][want]).all(), "winStart differs"
    assert (w1[got] == ref["t1"][want] + SESS_GAP).all(), "winEnd differs"
    mids = np_quantile_estimate(
        np.eye(qcfg.n_bins, dtype=np.int64), 1.0, qcfg)[0]
    m1 = mids[1:]                        # increasing
    off = 0
    for name, key in (("p50", "b50"), ("p99", "b99")):
        v = np.array([r[name] for r in rows], np.float32)[got]
        pos = np.clip(np.searchsorted(m1, v), 1, len(m1) - 1)
        gidx = np.where(np.abs(m1[pos - 1] - v) <= np.abs(m1[pos] - v),
                        pos - 1, pos) + 1
        gidx = np.where(v == 0, 0, gidx)
        assert (np.abs(v - mids[gidx]) <= 2 * np.spacing(mids[gidx])
                ).all(), f"{name}: not a bucket midpoint"
        wb = ref[key][want]
        bad = gidx != wb
        if bad.any():
            assert (np.abs(gidx[bad] - wb[bad]) == 1).all(), \
                f"{name}: more than one bucket apart"
            assert ref["edge"][want][bad].all(), \
                f"{name}: differs away from a bin edge"
            off += int(bad.sum())
    return dict(sessions_checked=n, one_bucket_apart=off,
                sessions_with_edge_values=int(ref["edge"].sum()),
                still_open=ref["open"])


SESS_KERNELS = ("session_step", "session_merge", "session_extract",
                "session_remap")


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    if isinstance(x, list):    # key shards' arenas or stores, ShardedState
        return type(x)(_clone(v) for v in x)
    return x


class _Capture:
    """A kernel wrapper called through a hook that keeps a clone of the
    positional arguments of its first call made while armed[0] is true
    (or, for the wrapper named `always`, its first call whenever it
    comes); the positions in `drop` (a fresh output) are kept as None,
    keyword arguments (an `out` store) not at all. The wrapper counts its
    launches through its module name, which names this hook while it is
    installed, so `launches` reads and writes the wrapper's own count."""

    def __init__(self, name, fn, store, armed, always: str, drop=()):
        self._name, self._fn, self._store, self._armed = (name, fn, store,
                                                          armed)
        self._always, self._drop = always, drop

    def __call__(self, *args, **kw):
        name = self._name
        if name not in self._store and (self._armed[0]
                                        or name == self._always):
            self._store[name] = tuple(
                None if i in self._drop else _clone(a)
                for i, a in enumerate(args))
        return self._fn(*args, **kw)

    @property
    def launches(self) -> int:
        return self._fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self._fn.launches = n


@contextlib.contextmanager
def capturing(store: dict, armed: list, joins: bool = False):
    """For the block's duration each session wrapper (each join wrapper
    and the touched extract, with `joins`) is called through a _Capture
    hook; the wrappers are restored on exit. The remap's and the eviction's first calls are
    kept whenever they come; the step's and merge's fresh arena not."""
    from hstream_tpu_torch.engine import join_lattice as jl
    from hstream_tpu_torch.engine import session_lattice as sl

    from hstream_tpu_torch.engine import lattice

    mod, names, always = ((jl, JOIN_KERNELS, "join_evict") if joins
                          else (sl, SESS_KERNELS, "session_remap"))
    hooks = [(mod, n) for n in names]
    if joins:    # the inner lattice's touched extract (B6 at its shape)
        hooks.append((lattice, "extract_touched"))
    orig = {(m, n): getattr(m, n) for m, n in hooks}
    for (m, n), fn in orig.items():
        drop = (2,) if n in ("session_step", "session_merge") else ()
        setattr(m, n, _Capture(n, fn, store, armed, always, drop))
    try:
        yield
    finally:
        for (m, n), fn in orig.items():
            setattr(m, n, fn)


def session_run(src, n_batches, mode, captured=None):
    """Drive the session query through SessionExecutor.process_columnar
    (deferred close decode, a drain every 8 batches). With a `captured`
    dict, the arguments of one call of each session kernel over the last
    4 batches (of the remap, its first) are kept there, so that the
    kernels can be held against their plain versions at the path's own
    inputs."""
    from hstream_tpu_torch.engine import SessionExecutor

    node, schema = session_plan()
    ex = SessionExecutor(node, schema)
    ex.defer_close_decode = True
    ex.device_session_mode = mode
    rows, fresh = [], []
    fetches = 0           # one per drain per buffer shape
    armed = [False]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (capturing(captured, armed) if captured is not None
          else contextlib.nullcontext()):
        for b in range(n_batches):
            armed[0] = b >= n_batches - 4
            ts, cols = src.get(b)
            t_sub = time.perf_counter()
            cycles = ex.session_stats["close_cycles"]
            rows.extend(ex.process_columnar(ts, cols))
            if (b + 1) % SESS_DRAIN_EVERY == 0 or b == n_batches - 1:
                fetches += len({tuple(p[3].shape)
                                for p in ex._pending_closes})
                rows.extend(ex.drain_closed())
                if len(fresh) < 4 and \
                        ex.session_stats["close_cycles"] > cycles:
                    # freshness: this batch closed sessions; submit to
                    # rows
                    fresh.append((time.perf_counter() - t_sub) * 1e3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    assert ex.session_stats["close_fetches"] == fetches, \
        (ex.session_stats, fetches)
    return ex, rows, wall, counts, fresh


def session_path(dev, results) -> dict:
    """BASELINE config 4 at full width: 48 x 2^20 records over 100,000
    user slots in record mode, rows against numpy; then the first 12
    batches in segment mode (the merge kernel on a path)."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.sketches import QuantileConfig

    qcfg = QuantileConfig()
    t_gen = time.perf_counter()
    src = SessionStream(seed=11,
                        n_batches=SESS_BATCHES + SESS_PROFILE_BATCHES)
    ref = session_reference(src, SESS_BATCHES, qcfg)
    ref_seg = session_reference(src, SESS_SEG_BATCHES, qcfg)
    t_gen = time.perf_counter() - t_gen
    captured: dict = {}
    ex, rows, wall, counts, fresh = session_run(src, SESS_BATCHES,
                                                "record", captured)
    st = dict(ex.session_stats)
    assert ex.device_fallbacks == 0, ex.device_fallbacks
    assert st["batches"] == st["step_dispatches"] == SESS_BATCHES, st
    assert counts["session_step"] == SESS_BATCHES, counts
    assert st["close_cycles"] == st["close_dispatches"] == \
        counts["session_extract"], (st, counts)
    assert counts["session_remap"] == st["remap_dispatches"] >= 1, \
        (st, counts)
    assert counts["session_merge"] == 0, counts
    for k in ("wire_decode", "scatter_aggregate", "fused_close"):
        assert counts[k] == 0, counts
    check = check_session_rows(rows, ref, qcfg)
    SINGLE_CARD["session"] = session_tuples(rows)   # phase 15a's reference
    arena_bytes = sum(ex.device_plane_bytes().values())
    stages = dict(ex.stage_stats)
    # the same stream's first 12 batches in segment mode
    exs, rows_s, wall_s, counts_s, _ = session_run(src, SESS_SEG_BATCHES,
                                                   "segment", captured)
    assert exs.device_fallbacks == 0
    assert counts_s["session_merge"] == SESS_SEG_BATCHES >= 1, counts_s
    assert counts_s["session_step"] == 0, counts_s
    check_s = check_session_rows(rows_s, ref_seg, qcfg)
    launches = {k: counts[k] + counts_s[k] for k in counts}
    prof = profile_session(ex, src)
    time_session_kernels(dev, results, captured)
    return dict(config="session (BASELINE 4)",
                events_per_sec=SESS_BATCHES * BATCH / wall, wall_s=wall,
                rows=len(rows), check=check, session_stats=st,
                launches=launches, record_launches=counts,
                freshness_ms=fresh, arena_bytes=arena_bytes,
                host_stage_s=stages, transfer_stats=ex.transfer_stats,
                segment=dict(events_per_sec=SESS_SEG_BATCHES * BATCH
                             / wall_s, rows=len(rows_s), check=check_s,
                             session_stats=dict(exs.session_stats),
                             launches=counts_s),
                profile=prof, stream_and_reference_s=t_gen)


# device events of the session kernels, by stage; the step is the sum of
# the first six
_SESSION_EVENTS = {"sort_range_kernel": "sort", "sort_keys_kernel": "sort",
                   "group_keys_kernel": "sort", "sort_pass_kernel": "sort",
                   "scan_": "scan", "init_copy_kernel": "init",
                   "fold_": "fold", "record_scatter": "scatter",
                   "fixup_kernel": "fixup", "extract_kernel": "extract",
                   "remap_": "remap", "Memcpy HtoD": "h2d_copy",
                   "Memcpy DtoH": "d2h_copy"}
_STEP_STAGES = ("sort", "scan", "init", "fold", "scatter", "fixup")


def profile_session(ex, src) -> dict:
    """The checked record run's executor over the stream's next
    SESS_PROFILE_BATCHES batches under torch.profiler: device ms per
    batch by stage, per step and per extract, and the device busy share
    of the window."""
    before = dict(ex.session_stats)

    def window():
        t0 = time.perf_counter()
        for b in range(SESS_BATCHES, SESS_BATCHES + SESS_PROFILE_BATCHES):
            ts, cols = src.get(b)
            ex.process_columnar(ts, cols)
        ex.drain_closed()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, devt = profiled(window)
    per = {}
    for name, us in devt.items():
        k = next((v for e, v in _SESSION_EVENTS.items() if e in name),
                 "other")
        per[k] = per.get(k, 0.0) + us / 1e3
    steps = ex.session_stats["step_dispatches"] - before["step_dispatches"]
    extracts = (ex.session_stats["close_dispatches"]
                - before["close_dispatches"])
    return dict(batches=SESS_PROFILE_BATCHES, wall_s=wall,
                device_ms_per_batch={k: v / SESS_PROFILE_BATCHES
                                     for k, v in per.items()},
                step_ms_per_call=sum(per.get(k, 0.0) for k in _STEP_STAGES)
                / max(steps, 1),
                extract_ms_per_call=per.get("extract", 0.0)
                / max(extracts, 1),
                device_busy_share=sum(devt.values()) / 1e6 / wall)


def sort_keys(code: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The (code, start) keys the session sort orders, as int64."""
    return (code.long() << 32) | (start.long() + (1 << 31))


def stage_ms(fn, iters: int) -> dict | None:
    """Device ms per call of fn by stage of the session kernels (their
    CUDA kernels' names, _SESSION_EVENTS), from torch.profiler; None when
    the profiler lost events (profiled_calls)."""
    devt = profiled_calls(fn, iters, "a session kernel")
    if devt is None:
        return None
    out: dict[str, float] = {}
    for name, us in devt.items():
        k = next((v for e, v in _SESSION_EVENTS.items() if e in name),
                 "other")
        out[k] = out.get(k, 0.0) + us / 1e3 / iters
    return out


def _arena_bytes(arena) -> int:
    return sum(int(v.nbytes) for v in arena.values())


def time_session_kernels(dev, results, captured):
    """Each session kernel on the path's own inputs (one call of each,
    kept by session_run: a step of the record run's last batches, a
    close cycle's extract, the compaction's remap, a merge of the
    segment run's last batches), held against its plain version on them
    (each into its own output) and timed beside it, its bound and a
    PyTorch yardstick."""
    from hstream_tpu_torch.engine import session_lattice as sl

    missing = [k for k in SESS_KERNELS if k not in captured]
    assert not missing, f"the path made no call of {missing}"

    # step: the path's arena and 2^20-record batch
    spec, arena, _, packed, inputs, gap, close_cut, delta = \
        captured["session_step"]
    cap, nb = arena["code"].shape[0], packed.shape[1]
    err, _want = step_vs_plain(spec, arena, packed, inputs, gap, close_cut,
                               delta, "session_step at the path's shapes")
    out = sl.init_session_arena(spec, cap, dev)

    def step():
        sl.session_step(spec, arena, out, packed, inputs, gap, close_cut,
                        delta)

    ms, call, srcm = kernel_ms(step, 10)
    stages = stage_ms(step, 10)
    plain = kernel_ms(lambda: sl.session_step_ref(
        spec, arena, out, packed, inputs, gap, close_cut, delta), 2)[0]
    m = cap + nb
    keys = torch.cat([sort_keys(arena["code"], arena["t0"]),
                      sort_keys(packed[0], packed[1])])
    lib = kernel_ms(lambda: torch.sort(keys), 10)[0]
    nbytes = 2 * _arena_bytes(arena) + int(packed.nbytes)
    b_ms, b_by = bound(nbytes, m)
    r = results["session_step"]
    r.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib, call_ms=call, ms_source=srcm, cap=cap, nb=nb,
             stages_ms=stages, path_max_abs_err=err)
    r["max_abs_err"] = max(r["max_abs_err"], err)
    log(f"session_step at the path's cap {cap}, {nb} records, close_cut "
        f"{close_cut}, delta {delta}: kernel and plain agree (SUM/AVG max "
        f"err {err:.3g}); {ms:.4f} ms (plain {plain:.4f}, torch.sort of "
        f"{m} keys {lib:.4f}, bound {b_ms:.4f} by {b_by}; by stage "
        f"{json.dumps(stages)})")
    del out, _want

    # merge: the segment run's arena and one batch's segments
    sspec, sarena, _, seg, gap, close_cut, delta = captured["session_merge"]
    scap, ns = sarena["code"].shape[0], seg["code"].shape[0]
    err, _want = merge_vs_plain(sspec, sarena, seg, gap, close_cut, delta,
                                "session_merge at the path's shapes")
    sout = sl.init_session_arena(sspec, scap, dev)

    def merge():
        sl.session_merge(sspec, sarena, sout, seg, gap, close_cut, delta)

    ms, call, srcm = kernel_ms(merge, 10)
    stages = stage_ms(merge, 10)
    plain = kernel_ms(lambda: sl.session_merge_ref(
        sspec, sarena, sout, seg, gap, close_cut, delta), 2)[0]
    mkeys = torch.cat([sort_keys(sarena["code"], sarena["t0"]),
                       sort_keys(seg["code"], seg["t0"])])
    lib = kernel_ms(lambda: torch.sort(mkeys), 10)[0]
    nbytes = 2 * _arena_bytes(sarena) + _arena_bytes(seg)
    b_ms, b_by = bound(nbytes, scap + ns)
    r = results["session_merge"]
    r.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib, call_ms=call, ms_source=srcm, cap=scap,
             nseg=ns, stages_ms=stages, path_max_abs_err=err)
    r["max_abs_err"] = max(r["max_abs_err"], err)
    log(f"session_merge at the path's cap {scap}, {ns} segments, "
        f"close_cut {close_cut}, delta {delta}: kernel and plain agree "
        f"(SUM/AVG max err {err:.3g}); {ms:.4f} ms (plain {plain:.4f}, "
        f"torch.sort {lib:.4f}, bound {b_ms:.4f} by {b_by}; by stage "
        f"{json.dumps(stages)})")
    del sout, _want

    # extract: a close cycle's slots of the path's arena
    spec, earena, slots = captured["session_extract"]
    ecap = earena["code"].shape[0]
    n_sel = int((slots >= 0).sum())
    got = sl.session_extract(spec, earena, slots)
    slots_t = torch.from_numpy(slots).to(dev)
    want = sl.session_extract_ref(spec, earena, slots_t)
    torch.cuda.synchronize()
    assert torch.equal(got, want), \
        "session_extract differs at the path's shapes"
    ms, call, srcm = kernel_ms(lambda: sl.session_extract(spec, earena,
                                                          slots), 30)
    plain = kernel_ms(lambda: sl.session_extract_ref(spec, earena,
                                                     slots_t), 5)[0]
    per_slot = _arena_bytes(earena) // ecap
    nbytes = n_sel * per_slot + slots.nbytes \
        + (1 + len(spec.aggs)) * len(slots) * 4
    b_ms, b_by = bound(nbytes, n_sel * 2 * spec.qcfg.n_bins)
    results["session_extract"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, call_ms=call, ms_source=srcm, slots=n_sel,
        padded=len(slots))
    log(f"session_extract of the path's {n_sel} closing slots (padded "
        f"{len(slots)}) at cap {ecap}: bit-exact against plain; "
        f"{ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.5f} by {b_by})")
    del earena, got, want

    # remap: the compaction's code plane and table
    rarena, lut = captured["session_remap"]
    rcap, lcap = rarena["code"].shape[0], lut.shape[0]
    a, b = {"code": rarena["code"].clone()}, {"code": rarena["code"].clone()}
    sl.session_remap(a, lut)
    sl.session_remap_ref(b, lut)
    torch.cuda.synchronize()
    assert torch.equal(a["code"], b["code"]), \
        "session_remap differs at the path's shapes"
    code_arena = {"code": rarena["code"].clone()}
    ms, call, srcm = kernel_ms(lambda: sl.session_remap(code_arena, lut),
                               100)
    plain = kernel_ms(lambda: sl.session_remap_ref(code_arena, lut), 20)[0]
    code = code_arena["code"]
    lib = kernel_ms(lambda: lut[code.clamp(0, lcap - 1).long()], 20)[0]
    b_ms, b_by = bound(3 * rcap * 4, rcap)
    results["session_remap"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, call_ms=call, ms_source=srcm, cap=rcap, lcap=lcap)
    log(f"session_remap of the path's cap {rcap} codes through its lcap "
        f"{lcap} table: exact against plain; {ms:.4f} ms (plain "
        f"{plain:.4f}, indexing {lib:.4f}, bound {b_ms:.6f})")


# ---- phase 3 (joins): the join kernels against their plain versions -----

JOIN_SENT = 1 << 22
JOIN_WITHIN = 25


def join_values(rng, n_cols: int, n: int,
                subnormals: bool = False) -> np.ndarray:
    """int32 [n_cols, n] column planes of f32 bits: column 0 multiples of
    1/4 (a few NaN and inf), column 1 small integers, column 2 0.0 / 1.0,
    so every float sum is exact in any order; with `subnormals`, a sixth
    of each column subnormals of both signs (their sums are flushed to
    zero, and exact too)."""
    out = np.zeros((n_cols, n), np.int32)
    for c in range(n_cols):
        if c % 3 == 0:
            v = (rng.integers(-8, 24, n) / 4).astype(np.float32)
            v[rng.random(n) < 0.03] = np.nan
            v[rng.random(n) < 0.02] = np.inf
        elif c % 3 == 1:
            v = rng.integers(-50, 50, n).astype(np.float32)
        else:
            v = rng.integers(0, 2, n).astype(np.float32)
        if subnormals:
            v[::6] = rng.choice(np.array([1e-45, -1e-45, 1e-40, -3e-39],
                                         np.float32), v[::6].shape[0])
        out[c] = v.view(np.int32)
    return out


def join_store(dev, rng, cap: int, n_cols: int, n_live: int,
               codes: int = 6, ts_range=(-60, 120),
               subnormals: bool = False) -> dict:
    """A sorted store on the card: n_live entries over few codes and a
    narrow ts range (equal (code, ts) runs, negative relative times),
    then sentinel slots that keep random flags and columns, as evicted
    entries do."""
    code = np.full(cap, JOIN_SENT, np.int32)
    ts = np.zeros(cap, np.int32)
    c = rng.integers(0, codes, n_live)
    t = rng.integers(*ts_range, n_live, dtype=np.int64)
    o = np.lexsort((t, c))
    code[:n_live], ts[:n_live] = c[o], t[o]
    flags = rng.integers(0, 1 << 28, cap).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in (
        ("code", code), ("ts", ts), ("flags", flags),
        ("cols", join_values(rng, n_cols, cap, subnormals)))}


def join_batch(dev, rng, bcap: int, n: int, n_cols: int, codes: int = 6,
               n_keys: int = 8, ts_range=(-60, 150),
               subnormals: bool = False) -> torch.Tensor:
    """A batch sorted by (code, ts), padded with (sentinel, 0)."""
    buf = np.zeros((4 + n_cols, bcap), np.int32)
    c = rng.integers(0, codes, n)
    t = rng.integers(*ts_range, n, dtype=np.int64)
    o = np.lexsort((t, c))
    buf[0, :n], buf[1, :n] = c[o], t[o]
    buf[0, n:] = JOIN_SENT
    buf[2, :n] = rng.integers(0, n_keys, n)
    buf[3, :n] = rng.integers(0, 1 << 28, n)
    buf[4:, :n] = join_values(rng, n_cols, n, subnormals)
    return torch.from_numpy(buf).to(dev)


def stores_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in ("code", "ts", "flags",
                                                 "cols"))


# (cap, bcap, n, n_cols mine, n_cols other, match_cap, cutoff)
JOIN_CASES = [(64, 16, 10, 3, 3, 256, -(1 << 31)),
              (64, 16, 16, 3, 3, 8, -(1 << 31)),     # truncated
              (256, 64, 50, 3, 0, 512, 0),           # dead below cutoff
              (256, 64, 0, 0, 3, 64, -10),           # n = 0
              (1 << 16, 5000, 5000, 2, 1, 1 << 20, -30)]
# the probe plan's branches (join_core.cuh): name -> (cap, live, bcap, n,
# codes, ts range, within, cutoff, match_cap); "staged" keeps each tile's
# store window in shared memory, "skew" (one key's run of ~30,000
# entries) overflows it, "wraps" has ts - within and ts + within wrap
# int32 (the whole-store branch), "split" records whose ~8,000 matches
# each span several expansion tiles, "large" a batch over 2^20 records
# (12,288 tiles: the count scan's look-back reads 96 rounds of 128),
# "edge" 469 tiles, whose 6144-entry windows fill 48 KB on the H100's
# 132 SMs (with the kernel's static words, past the default limit)
JOIN_PLAN_CASES = {
    "staged": (1 << 18, 200_000, 1 << 16, 60_000, 20_000, (-500, 500), 25,
               -(1 << 31), 1 << 20),
    "skew": (1 << 16, 60_000, 1024, 1000, 2, (0, 100_000), 2000, -50,
             1 << 21),
    "wraps": (1 << 14, 12_000, 2048, 2000, 50,
              (-(1 << 31), (1 << 31) - 1), 1 << 30, -(1 << 31), 1 << 20),
    "split": (1 << 14, 16_000, 128, 100, 1, (0, 1000), 500, -(1 << 31),
              1 << 20),
    "large": (1 << 22, 2_000_000, 3 << 20, 3_000_000, 20_000, (0, 5000),
              25, -(1 << 31), 1 << 23),
    "edge": (1 << 18, 200_000, 120_000, 120_000, 20_000, (-500, 500), 25,
             -(1 << 31), 1 << 21),
}
PROBE_BRANCH_NAMES = ("auto", "window", "whole")


def join_plan_case(dev, name: str, seed: int):
    cap, live, bcap, n, codes, tsr, within, cutoff, mc = \
        JOIN_PLAN_CASES[name]
    rng = np.random.default_rng(seed)
    other = join_store(dev, rng, cap, 1, live, codes, tsr)
    mine = join_store(dev, rng, cap, 2, live // 2, codes, tsr)
    bt = join_batch(dev, rng, bcap, n, 2, codes, ts_range=tsr)
    return mine, other, bt, n, within, cutoff, mc


def check_join_probe(dev, results):
    """B15 (probe in pack mode + merge-insert) and B16 (probe only, at a
    match_cap below the total and then above it), exact, in each probe
    branch forced (kb.PROBE_*); then the plan's hard cases (a staged
    window, a skewed key, int32 wrap, a record over several tiles, a
    batch over 2^20 records, a window of 48 KB)."""
    from hstream_tpu_torch.engine import join_lattice as jl

    cases = []
    for i, (cap, bcap, n, nm, no, mc, cutoff) in enumerate(JOIN_CASES):
        rng = np.random.default_rng(100 + i)
        mine = join_store(dev, rng, cap, nm, cap // 3)
        other = join_store(dev, rng, cap, no, cap // 2)
        bt = join_batch(dev, rng, bcap, n, nm)
        cases.append((f"case {i}", mine, other, bt, n, JOIN_WITHIN, cutoff,
                      mc))
    for j, name in enumerate(JOIN_PLAN_CASES):
        cases.append((name, *join_plan_case(dev, name, 150 + j)))
    totals = {}
    for what, mine, other, bt, n, within, cutoff, mc in cases:
        nm = mine["cols"].shape[0]
        cap = mine["code"].shape[0]
        want_m, want_p = jl.join_probe_insert_ref(mine, other, bt, n,
                                                  within, cutoff, mc, nm)
        total = int(want_p[0, 0])
        totals[what] = total
        for branch, bname in enumerate(PROBE_BRANCH_NAMES):
            before = jl.join_probe_insert.launches
            got_m, got_p = jl.join_probe_insert(
                mine, other, bt, n, within, cutoff, mc, nm,
                out=jl.empty_join_store(cap, nm, dev), branch=branch)
            torch.cuda.synchronize()
            assert jl.join_probe_insert.launches == before + 1
            assert torch.equal(want_p, got_p), \
                f"join probe differs, {what} ({bname})"
            assert stores_equal(want_m, got_m), \
                f"join insert differs, {what} ({bname})"
            assert jl.store_sorted(got_m)
            for width in (max(total // 2, 1), max(total, 1) * 2):
                want = jl.join_probe_ref(other, bt, n, within, cutoff,
                                         width, nm)
                got = jl.join_probe_only(other, bt, n, within, cutoff,
                                         width, nm, branch=branch)
                torch.cuda.synchronize()
                assert torch.equal(want, got), \
                    f"join probe-only differs, {what} ({bname})"
                assert int(got[0, 0]) == total
    src = "hstream_tpu_torch/engine/kernels/csrc/"
    results["join_probe_insert"] = dict(
        route="cuda", source=src + "join_probe.cu",
        sources=[src + "join_core.cuh", src + "join_probe.cu",
                 src + "join_insert.cu"],
        replaces="hstream_tpu/engine/lattice.py:984", max_abs_err=0.0,
        branch_case_totals=totals)
    results["join_probe_only"] = dict(
        route="cuda", source=src + "join_probe.cu",
        replaces="hstream_tpu/engine/lattice.py:1001", max_abs_err=0.0)
    log(f"join_probe_insert / join_probe_only, each probe branch forced "
        f"({', '.join(PROBE_BRANCH_NAMES)}): equal (code, ts) runs across "
        "store and batch, sentinels that kept flags and columns, dead "
        "entries below the cutoff, negative times, n = 0, a match_cap "
        "below the total (true total in the header) and above it, a "
        "staged window, a skewed key, int32 wrap, a record over several "
        f"tiles, 3 x 2^20 records, a 48 KB window (totals "
        f"{json.dumps(totals)}): exact")


def join_inner(dev, where: bool):
    """An inner window executor on the card over the joined columns a, b,
    c: COUNT(*), SUM(a), MIN(b), MAX(c), COUNT(c) by k over TUMBLE(100
    ms), WHERE a > 0 optionally (the expression kernel)."""
    from hstream_tpu_torch.engine import (AggKind, AggregateNode, AggSpec,
                                          ColumnType, FilterNode,
                                          QueryExecutor, Schema, SourceNode,
                                          TumblingWindow)
    from hstream_tpu_torch.engine.expr import BinOp, Col, Lit

    schema = Schema.of(k=ColumnType.STRING, a=ColumnType.FLOAT,
                       b=ColumnType.FLOAT, c=ColumnType.FLOAT)
    child = SourceNode("s", schema)
    if where:
        child = FilterNode(child, BinOp(">", Col("a"), Lit(0.0)))
    node = AggregateNode(
        child=child, group_keys=[Col("k")],
        window=TumblingWindow(100, grace_ms=0),
        aggs=[AggSpec(AggKind.COUNT_ALL, "n"),
              AggSpec(AggKind.SUM, "s", input=Col("a")),
              AggSpec(AggKind.MIN, "lo", input=Col("b")),
              AggSpec(AggKind.MAX, "hi", input=Col("c")),
              AggSpec(AggKind.COUNT, "nc", input=Col("c"))])
    return QueryExecutor(node, schema, initial_keys=8, device=dev)


# feed plans: a from the probing batch, b from the store, c a bare name
# whose SQL left side is the batch ("both") or the store ("both_o")
JOIN_FEEDS = {
    "left": (("a", "f32", "m", 0, -1), ("b", "f32", "o", -1, 1),
             ("c", "f32", "both", 2, 2)),
    "right": (("a", "f32", "o", -1, 0), ("b", "f32", "m", 1, -1),
              ("c", "f32", "both_o", 2, 2)),
}


def join_feed(name: str, ex, where: bool):
    feed = JOIN_FEEDS[name]
    src = {f[0]: f[2:] for f in feed}
    nulls = tuple((key, tuple(src[c] for c in refs))
                  for key, refs in ex._null_specs)
    return feed, nulls, ((src["a"],) if where else ())


def step_vs_plain_join(args: tuple, what: str, branch=None) -> int:
    """One fused join call (join_probe_insert_step's positional `args`)
    with the kernels and with the plain version, each on its own clone of
    the inner state (args[9]) and into its own store: the store, the
    total and every state plane exact (SUM within its order bound, which
    is exact on these inputs: multiples of 1/4, or counts only on the
    path). Returns the match total."""
    from hstream_tpu_torch.engine import join_lattice as jl

    mine, batch, state = args[0], args[2], args[9]
    runs = []
    for fn in (jl.join_probe_insert_step, jl.join_probe_insert_step_ref):
        st = {k: v.clone() for k, v in state.items()}
        kw = ({"out": jl.empty_join_store(mine["code"].shape[0],
                                          mine["cols"].shape[0],
                                          batch.device), "branch": branch}
              if fn is jl.join_probe_insert_step else {})
        new, total = fn(*args[:9], st, *args[10:], **kw)
        runs.append((new, int(total), st))
    torch.cuda.synchronize()
    (got_m, got_t, st_k), (want_m, want_t, st_p) = runs
    assert got_t == want_t, f"{what}: totals differ"
    assert stores_equal(want_m, got_m), f"{what}: the insert differs"
    for k, v in st_p.items():
        assert torch.equal(st_k[k], v), f"{what}: {k} differs"
    return want_t


def check_join_step(dev, results):
    """B17: the probe in feed mode, the window step's kernels on its
    columns (the expression kernel with a WHERE, the scatter) and the
    insert, against the plain version: both feed layouts, null and
    present bits on both sides, filter-NULL columns, a truncating
    match_cap and n = 0."""
    from hstream_tpu_torch.engine import join_lattice as jl

    cases = [(256, 64, 50, 512, -30), (64, 16, 16, 4, -(1 << 31)),
             (64, 16, 0, 64, 0), (1 << 16, 5000, 5000, 1 << 20, -30)]
    n_checked = 0
    for i, (cap, bcap, n, mc, cutoff) in enumerate(cases):
        for feed_name in JOIN_FEEDS:
            for where in (False, True):
                # subnormal columns in case 3 (flushed where the
                # reference flushes them: the WHERE, SUM, MIN, MAX)
                rng = np.random.default_rng(200 + i * 4 + where)
                sub = i == 3
                ex = join_inner(dev, where)
                args = (join_store(dev, rng, cap, 3, cap // 3,
                                   subnormals=sub),
                        join_store(dev, rng, cap, 3, cap // 2,
                                   subnormals=sub),
                        join_batch(dev, rng, bcap, n, 3, subnormals=sub), n,
                        JOIN_WITHIN, cutoff, mc, 3, ex.spec, ex.state, 120,
                        300, ex._progs, join_feed(feed_name, ex, where))
                for branch in (range(3) if where else (None,)):
                    step_vs_plain_join(
                        args, f"join_probe_step case {i} {feed_name} "
                        f"where={where} branch={branch}", branch)
                    n_checked += 1
    results["join_probe_step"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/join_probe.cu",
        sources=["join_probe.cu (feed mode)", "expr.cu", "scatter.cu",
                 "join_insert.cu"],
        replaces="hstream_tpu/engine/lattice.py:1082", max_abs_err=0.0)
    log(f"join_probe_step: {n_checked} fused calls (feed sources m, o, both, "
        "both_o; null and present bits on both sides; filter-NULL and "
        "WHERE; truncating match_cap; n = 0; subnormal columns; each probe "
        "branch forced) against the plain version: store and every state "
        "plane exact")


# the eviction's checks: (cap, cutoff, delta, live entries left, right);
# its tiles are kb.JOIN_EVICT_THREADS x JOIN_EVICT_PER = 2048 entries
EVICT_CASES = [
    (256, 0, 0, 170, 85), (256, 40, 37, 170, 85), (256, -20, -100, 170, 85),
    (1 << 16, 30, 0, 43690, 21845), (1 << 16, -(1 << 31), 5, 43690, 21845),
    (2 * 2048 + 37, 40, 37, 3000, 1500),           # not a multiple of a tile
    (20 * 2048 + 5, -20, -100, 30000, 9000),       # many tiles
    (3 * (1 << 20) + 7, 30, 5, 2_500_000, 1_000_000),  # 1537 tiles a side
    (5000, -(1 << 31), 0, 5000, 5000),             # every slot live
    (5000, 1 << 20, 0, 4000, 2000),                # every entry dead
    (5000, 40, 0, 0, 0),                           # none resident
]


def check_join_evict(dev, results):
    """B18: both sides at once, delta 0, > 0 and < 0, dead entries below
    the cutoff and sentinels that kept their columns, stores below one
    tile, not a multiple of it and over many, every slot live, every entry
    dead, none resident (EVICT_CASES); and the remap kernel's sentinel
    flag (the join's code remap)."""
    from hstream_tpu_torch.engine import join_lattice as jl
    from hstream_tpu_torch.engine import session_lattice as sl

    for i, (cap, cutoff, delta, nl, nr) in enumerate(EVICT_CASES):
        rng = np.random.default_rng(300 + i)
        left = join_store(dev, rng, cap, 3, nl)
        right = join_store(dev, rng, cap, 1, nr)
        wl, wr, wn = jl.join_evict_ref(left, right, cutoff, delta)
        before = jl.join_evict.launches
        gl, gr, gn = jl.join_evict(left, right, cutoff, delta, out=[
            jl.empty_join_store(cap, 3, dev), jl.empty_join_store(cap, 1, dev)])
        torch.cuda.synchronize()
        assert jl.join_evict.launches == before + 1
        assert stores_equal(wl, gl) and stores_equal(wr, gr), \
            f"join_evict differs, case {i}"
        assert torch.equal(wn, gn) and jl.store_sorted(gl) and \
            jl.store_sorted(gr)
    results["join_evict"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/join_evict.cu",
        replaces="hstream_tpu/engine/lattice.py:1131", max_abs_err=0.0)
    # the remap's sentinel flag: codes below, at and above the table
    rng = np.random.default_rng(390)
    code = np.sort(rng.integers(0, 3000, 4096)).astype(np.int32)
    code[-300:] = JOIN_SENT
    table = np.cumsum(rng.random(2048) < 0.7).astype(np.int32)
    a = {"code": torch.from_numpy(code).to(dev)}
    b = {"code": a["code"].clone()}
    lut = torch.from_numpy(table).to(dev)
    sl.session_remap(a, lut, sent_above=True)
    sl.session_remap_ref(b, lut, sent_above=True)
    torch.cuda.synchronize()
    assert torch.equal(a["code"], b["code"]), "the join remap differs"
    assert int((a["code"] == JOIN_SENT).sum()) == int((code >= 2048).sum())
    log(f"join_evict: both sides, {len(EVICT_CASES)} stores (delta 0, > 0 "
        "and < 0, dead entries and sentinels with columns, caps off the "
        "tile, all live, all dead, none resident): exact; the remap "
        "kernel's sentinel flag "
        "(codes at and above the table map to the sentinel): exact")


# ---- phase 8: the join path, BASELINE config 5 ------------------------------

JOIN_SQL = ("SELECT l.k, COUNT(*) AS c FROM l INNER JOIN r "
            "WITHIN (INTERVAL 1 SECOND) ON l.k = r.k "
            "GROUP BY l.k, TUMBLING (INTERVAL 10 SECOND) "
            "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
# phase 8b: WITHIN 10 s over TUMBLE(1 s) spans more windows than the
# lattice's slots, so no batch fuses; a 4 s grace keeps the pairs that
# the deferred (depth 4) and coalesced match drains step late in time
JOIN_FETCH_SQL = ("SELECT l.k, COUNT(*) AS c, SUM(l.x) AS s FROM l INNER "
                  "JOIN r WITHIN (INTERVAL 10 SECOND) ON l.k = r.k "
                  "GROUP BY l.k, TUMBLING (INTERVAL 1 SECOND) "
                  "GRACE BY INTERVAL 4 SECOND EMIT CHANGES;")
JOIN_BATCH = 1 << 20
JOIN_KEYS = 512_000          # bench.py's 8192 records / 4000 keys, scaled
JOIN_WARM = 14               # bench.py's warm-up and timed batches
JOIN_TIMED = 12               # bench.py times 20; cut for the time limit
JOIN_PROFILE = 8
JOIN_FRESH = 4
JOIN_MS_PER_BATCH = 500
FETCH_BATCH = 1 << 16
FETCH_KEYS = 32_000
FETCH_WARM = 4
FETCH_TIMED = 8


def _join_plan(sql: str, within_s: int, size_ms: int, grace_ms: int,
               sum_x: bool):
    from hstream_tpu_torch.engine.expr import BinOp, Col
    from hstream_tpu_torch.engine.plan import (AggKind, AggregateNode,
                                               AggSpec, SourceNode)
    from hstream_tpu_torch.engine.types import ColumnType
    from hstream_tpu_torch.engine.window import TumblingWindow
    from hstream_tpu_torch.sql import ast, plans

    aggs = [AggSpec(AggKind.COUNT_ALL, "COUNT(*)")]
    post = [("l.k", Col("l.k")), ("c", Col("COUNT(*)"))]
    inferred = {"l.k": ColumnType.FLOAT}
    if sum_x:
        aggs.append(AggSpec(AggKind.SUM, "SUM(l.x)", input=Col("l.x")))
        post.append(("s", Col("SUM(l.x)")))
        inferred["l.x"] = ColumnType.FLOAT
    node = AggregateNode(child=SourceNode("l", None),
                         group_keys=[Col("l.k")],
                         window=TumblingWindow(size_ms, grace_ms=grace_ms),
                         aggs=aggs, having=None, post_projections=post)
    return plans.SelectPlan(
        sql=sql, source="l", node=node,
        schema_req=plans.SchemaRequirement(inferred=inferred),
        emit_changes=True,
        join=ast.JoinClause(join_type="INNER",
                            right=ast.StreamRef(name="r", alias=None),
                            within=ast.Interval(within_s, "SECOND"),
                            on=BinOp("=", Col("k", "l"), Col("k", "r")),
                            table=False),
        source_alias=None)


def join_plan():
    """BASELINE config 5's plan (bench.py:453-567), built from the port's
    dataclasses as the reference's codegen lowers JOIN_SQL (a CPU test
    holds the two equal)."""
    return _join_plan(JOIN_SQL, 1, 10_000, 0, False)


def join_fetch_plan():
    return _join_plan(JOIN_FETCH_SQL, 10, 1_000, 4_000, True)


class JoinStream:
    """bench.py's config-5 stream (bench.py:466-486), scaled: batches of
    `n` records over `n_keys` keys k{i}, 8 pre-generated key columns
    cycled, batch b spanning ts base + 500 b + sort(randint(0, 500)),
    sides alternating r, l; x = normal(1, 1) for the fetch path."""

    def __init__(self, seed: int, n: int, n_keys: int, with_x: bool):
        rng = np.random.default_rng(seed)
        self.n, self.seed = n, seed
        self.keys = np.array([f"k{i}" for i in range(n_keys)], object)
        self.kidx = [rng.integers(0, n_keys, n) for _ in range(8)]
        self.xs = ([rng.normal(1, 1, n) for _ in range(8)] if with_x
                   else None)

    def ts(self, b: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, b))
        return (BASE_TS + b * JOIN_MS_PER_BATCH
                + np.sort(rng.integers(0, JOIN_MS_PER_BATCH, self.n))
                .astype(np.int64))

    def side(self, b: int) -> str:
        return "l" if b % 2 else "r"

    def get(self, b: int):
        cols = {"k": self.keys[self.kidx[b % 8]]}
        cols["x"] = (self.xs[b % 8] if self.xs is not None
                     else np.ones(self.n, np.float32))
        return self.ts(b), cols, self.side(b)


def join_reference(src: JoinStream, batches: int, size_ms: int,
                   within: int) -> dict:
    """Per (key index, winStart) with pairs, in (key, window) order: the
    count, sum of left x and sum of |x| of the joined pairs of the first
    `batches` batches, by numpy alone. A pair's joined
    ts is max of the two; with this stream no pair is late or hidden by
    retention, so the pairs in [S, E) are C(E) - C(S), where C(X) counts
    (and sums the left x of) equal-key pairs with |dt| <= within and both
    ts < X: one searchsorted pair per left record."""
    sides = {"l": [], "r": []}
    for b in range(batches):
        ts, _cols, side = src.get(b)
        x = src.xs[b % 8] if src.xs is not None else np.ones(src.n)
        sides[side].append((src.kidx[b % 8].astype(np.int64), ts - BASE_TS,
                            x.astype(np.float64)))
    lk, lt, lx = (np.concatenate([p[i] for p in sides["l"]])
                  for i in range(3))
    rk, rt = (np.concatenate([p[i] for p in sides["r"]]) for i in range(2))
    span = 1 << 40
    rkey = np.sort(rk * span + rt)
    # left records in (key, ts) order: the searches below then run over
    # ascending queries (numpy narrows each search from the last)
    order = np.argsort(lk * span + lt, kind="stable")
    lk, lt, lx = lk[order], lt[order], lx[order]
    lo = np.searchsorted(rkey, lk * span + lt - within, "left")
    t_end = batches * JOIN_MS_PER_BATCH
    bounds = list(range(0, t_end + size_ms, size_ms))

    def c_of(x_ms: int):
        sel = lt < x_ms
        hi = np.searchsorted(rkey, lk[sel] * span
                             + np.minimum(lt[sel] + within, x_ms - 1),
                             "right")
        cnt = np.maximum(hi - lo[sel], 0)
        n_k = len(src.keys)
        return (np.bincount(lk[sel], weights=cnt, minlength=n_k),
                np.bincount(lk[sel], weights=cnt * lx[sel], minlength=n_k),
                np.bincount(lk[sel], weights=cnt * np.abs(lx[sel]),
                            minlength=n_k))

    cs = [c_of(x) for x in bounds]
    parts = []
    for w in range(len(bounds) - 1):
        c = cs[w + 1][0] - cs[w][0]
        keys = np.nonzero(c > 0)[0]
        parts.append((keys, np.full(len(keys), BASE_TS + bounds[w]),
                      np.rint(c[keys]).astype(np.int64),
                      (cs[w + 1][1] - cs[w][1])[keys],
                      (cs[w + 1][2] - cs[w][2])[keys]))
    k, w, c, s, a = (np.concatenate([p[i] for p in parts])
                     for i in range(5))
    order = np.argsort(k * (1 << 44) + (w - BASE_TS), kind="stable")
    return dict(key=k[order], win=w[order], count=c[order], sum=s[order],
                abs=a[order])


class ChangeLog:
    """The final change per (key, window) of a changelog run, kept as
    numpy columns batch by batch (not as row dicts)."""

    def __init__(self, keys: np.ndarray):
        self.index = {k: i for i, k in enumerate(keys.tolist())}
        self.parts: list[tuple] = []
        self.rows = 0

    def add(self, out) -> None:
        from hstream_tpu_torch.common.columnar import ColumnarEmit

        n = len(out)
        if not n:
            return
        self.rows += n
        if isinstance(out, ColumnarEmit):
            c = out.cols
            k = np.fromiter((self.index[v] for v in c["l.k"].tolist()),
                            np.int64, n)
            self.parts.append((k, np.asarray(c["winStart"], np.int64),
                               np.asarray(c["c"], np.int64),
                               np.asarray(c.get("s", np.zeros(n)),
                                          np.float64)))
            return
        idx = self.index
        self.parts.append((
            np.fromiter((idx[r["l.k"]] for r in out), np.int64, n),
            np.fromiter((r["winStart"] for r in out), np.int64, n),
            np.fromiter((r["c"] for r in out), np.int64, n),
            np.fromiter((r.get("s", 0.0) for r in out), np.float64, n)))

    def final(self):
        """(key, winStart, count, sum) of the last change of each (key,
        window), in (key, window) order."""
        k, w, c, s = (np.concatenate([p[i] for p in self.parts])
                      for i in range(4))
        comp = k * (1 << 44) + (w - BASE_TS)
        _u, first_rev = np.unique(comp[::-1], return_index=True)
        last = len(comp) - 1 - first_rev
        return k[last], w[last], c[last], s[last]


def check_join_changes(log_: ChangeLog, ref: dict, with_sum: bool) -> dict:
    """Every (key, window) with pairs got a change, its final count is
    exact and its SUM within 2 * n * 2^-24 * sum|x|; no change for a
    (key, window) without pairs."""
    k, w, c, s = log_.final()
    assert len(k) == len(ref["key"]), (len(k), len(ref["key"]))
    same = (k == ref["key"]) & (w == ref["win"])
    assert same.all(), ("changes for (key, window)s without pairs",
                        k[~same][:5], w[~same][:5])
    bad = c != ref["count"]
    assert not bad.any(), ("counts differ", k[bad][:5], w[bad][:5],
                           c[bad][:5], ref["count"][bad][:5])
    worst = 0.0
    if with_sum:
        lim = 2 * ref["count"] * U * ref["abs"] + 1e-30
        ratio = np.abs(s - ref["sum"]) / lim
        assert (ratio <= 1).all(), ("SUM beyond the order bound",
                                    float(ratio.max()))
        worst = float(ratio.max())
    return dict(windows=len(k), change_rows=log_.rows,
                worst_sum_err_over_bound=worst)


# the join wrappers (engine/join_lattice.py attributes)
JOIN_KERNELS = ("join_probe_insert", "join_probe_only",
                "join_probe_insert_step", "join_evict")


def _join_executor(plan, batch: int, dev):
    from hstream_tpu_torch.engine import JoinExecutor
    from hstream_tpu_torch.sql import make_executor

    ex = make_executor(plan, sample_rows=[{"k": "k0", "x": 1.0}],
                       batch_capacity=4 * batch)
    assert isinstance(ex, JoinExecutor) and ex.device == dev, ex.device
    # bench.py's knobs (bench.py:488-499)
    ex.defer_change_decode = True
    ex.change_drain_depth = 8
    ex.async_change_drain = True
    return ex


# device events of the join path, by stage
_JOIN_EVENTS = {"group_": "compaction", "probe_window_kernel": "probe",
                "probe_bounds_kernel": "probe",
                "probe_expand_kernel": "probe", "split_kernel": "insert",
                "merge_kernel": "insert", "scatter_table": "scatter",
                "count_kernel": "evict", "scan_tiles_kernel": "evict",
                "move_kernel": "evict",
                "scatter_private": "scatter", "scatter_cluster": "scatter",
                "scatter_global": "scatter", "expr_kernel": "expression",
                "touched_": "touched_extract", "close_kernel": "close",
                "Memset": "memset",
                "Memcpy HtoD": "h2d_copy", "Memcpy DtoH": "d2h_copy"}


def _by_stage(devt: dict, batches: int) -> dict:
    per: dict[str, float] = {}
    for name, us in devt.items():
        k = next((v for e, v in _JOIN_EVENTS.items() if e in name), "other")
        per[k] = per.get(k, 0.0) + us / 1e3 / batches
    return per


def join_path(dev, results, captured) -> dict:
    """BASELINE config 5 at full width: 14 warm-up and 12 timed batches of
    2^20 records over 512,000 keys (bench.py's knobs), every final change
    per (key, window) against numpy; then freshness samples and a
    profiled window of 8 batches. events/s and change rows/s take the
    executor's time (its calls and the final flush), as bench.py's loop
    does, not the check's bookkeeping of the rows."""
    t_gen = time.perf_counter()
    src = JoinStream(5, JOIN_BATCH, JOIN_KEYS, with_x=False)
    t_gen = time.perf_counter() - t_gen
    ex = _join_executor(join_plan(), JOIN_BATCH, dev)
    log_ = ChangeLog(src.keys)
    armed = [False]
    zero_counts()
    host_batches_s = []
    with capturing(captured, armed, joins=True):
        for b in range(JOIN_WARM):
            ts, cols, side = src.get(b)
            t0 = time.perf_counter()
            log_.add(ex.process_columnar(ts, cols, stream=side))
            if ex._dev is None or b < 3:
                host_batches_s.append(time.perf_counter() - t0)
            if b == 1:
                ex.coalesce_rows = 1 << 15
            if b == P15_JOIN_BATCHES - 1:
                # the finals after phase 15b's batches, its single-card
                # reference (a flush: the warm-up's cadence only)
                log_.add(ex.flush_changes())
                SINGLE_CARD["join"] = log_.final()
        log_.add(ex.flush_changes())
        torch.cuda.synchronize()
        assert ex._dev is not None, "the device path did not activate"
        stats0 = dict(ex.join_stats)
        counts0 = launch_counts()
        call_ms = []
        rows0 = log_.rows
        for b in range(JOIN_WARM, JOIN_WARM + JOIN_TIMED):
            armed[0] = b == JOIN_WARM + JOIN_TIMED - 1
            ts, cols, side = src.get(b)
            t1 = time.perf_counter()
            out = ex.process_columnar(ts, cols, stream=side)
            call_ms.append((time.perf_counter() - t1) * 1e3)
            log_.add(out)
            assert ex._dev is not None
        t1 = time.perf_counter()
        out = ex.flush_changes()
        torch.cuda.synchronize()
        # the executor's time: its calls and the final flush (the rows'
        # numpy bookkeeping for the check is left out)
        wall = sum(call_ms) / 1e3 + time.perf_counter() - t1
        log_.add(out)
        armed[0] = False
    js = {k: ex.join_stats[k] - stats0[k] for k in stats0}
    counts = launch_counts()
    d = {k: counts[k] - counts0[k] for k in counts}
    timed_rows = log_.rows - rows0
    if js["fused_batches"] != JOIN_TIMED:
        log(f"join path: {JOIN_TIMED - js['fused_batches']} timed batches "
            f"refused by _fuse_ok")
    assert js["probe_batches"] == js["probe_dispatches"] == \
        js["fused_batches"] == JOIN_TIMED, js
    assert js["probe_fetches"] == 0 and js["match_redispatches"] == 0, js
    assert d["join_probe_step"] == d["scatter_aggregate"] == \
        d["touched_extract"] == JOIN_TIMED, d
    assert d["join_probe_insert"] == d["join_probe_only"] == \
        d["wire_decode"] == 0, d
    # freshness: submit -> changelog rows decoded (the flush forces the
    # deferred change drains), then a profiled window
    fresh = []
    b = JOIN_WARM + JOIN_TIMED
    for _ in range(JOIN_FRESH):
        ts, cols, side = src.get(b)
        t1 = time.perf_counter()
        log_.add(ex.process_columnar(ts, cols, stream=side))
        log_.add(ex.flush_changes())
        fresh.append((time.perf_counter() - t1) * 1e3)
        b += 1

    def window():
        t1 = time.perf_counter()
        for bb in range(b, b + JOIN_PROFILE):
            ts, cols, side = src.get(bb)
            log_.add(ex.process_columnar(ts, cols, stream=side))
        log_.add(ex.flush_changes())
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    pwall, devt = profiled(window)
    b += JOIN_PROFILE
    assert ex._dev is not None and ex.device_fallbacks == 0
    counts = launch_counts()
    assert ex.join_stats["evict_dispatches"] >= 1, ex.join_stats
    assert counts["join_evict"] == ex.join_stats["evict_dispatches"], \
        (counts, ex.join_stats)
    assert counts["join_probe_step"] == ex.join_stats["fused_batches"], \
        (counts, ex.join_stats)
    t_ref = time.perf_counter()
    check = check_join_changes(
        log_, join_reference(src, b, 10_000, 1000), with_sum=False)
    t_ref = time.perf_counter() - t_ref
    per = _by_stage(devt, JOIN_PROFILE)
    return dict(config="join (BASELINE 5)", batches=b,
                events_per_sec=JOIN_TIMED * JOIN_BATCH / wall, wall_s=wall,
                change_rows_per_sec=timed_rows / wall,
                change_rows_timed=timed_rows,
                p50_call_ms=float(np.percentile(call_ms, 50)),
                p99_call_ms=float(np.percentile(call_ms, 99)),
                freshness_ms=fresh, host_warmup_batches_s=host_batches_s,
                stage_s=dict(ex.stage_stats), join_stats=dict(ex.join_stats),
                timed_join_stats=js, launches=counts, check=check,
                store_cap=ex._dev["cap"], match_cap=ex._dev["match_cap"],
                inner_keys=ex._inner.spec.n_keys,
                device_plane_bytes=sum(ex.device_plane_bytes().values()),
                profile=dict(batches=JOIN_PROFILE, wall_s=pwall,
                             device_ms_per_batch=per,
                             device_busy_share=sum(devt.values()) / 1e6
                             / pwall),
                stream_s=t_gen, reference_s=t_ref)


def join_fetch_path(dev, results, captured) -> dict:
    """Phase 8b, the match-fetch path (B15) at a smaller depth: SUM(l.x)
    over WITHIN 10 s and TUMBLE(1 s), whose joined span no batch can fuse;
    2^16-record batches over 32,000 keys, 4 warm-up and 8 timed, match
    buffers fetched four batches at a time (stacked) and decoded
    columnar; every final change against numpy."""
    src = JoinStream(7, FETCH_BATCH, FETCH_KEYS, with_x=True)
    ex = _join_executor(join_fetch_plan(), FETCH_BATCH, dev)
    ex.match_drain_depth = 4
    log_ = ChangeLog(src.keys)
    armed = [False]
    zero_counts()
    n_batches = FETCH_WARM + FETCH_TIMED
    with capturing(captured, armed, joins=True):
        for b in range(FETCH_WARM):
            ts, cols, side = src.get(b)
            log_.add(ex.process_columnar(ts, cols, stream=side))
            if b == 1:
                ex.coalesce_rows = 1 << 15
        log_.add(ex.flush_changes())
        torch.cuda.synchronize()
        assert ex._dev is not None, "the device path did not activate"
        stats0 = dict(ex.join_stats)
        t0 = time.perf_counter()
        for b in range(FETCH_WARM, n_batches):
            armed[0] = b == n_batches - 1
            ts, cols, side = src.get(b)
            log_.add(ex.process_columnar(ts, cols, stream=side))
        log_.add(ex.flush_changes())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        armed[0] = False
    js = dict(ex.join_stats)
    counts = launch_counts()
    assert js["fused_batches"] == 0 and js["probe_fetches"] >= 1, js
    assert js["probe_batches"] == js["probe_dispatches"] == \
        counts["join_probe_insert"], (js, counts)
    assert js["probe_fetches"] < js["probe_batches"], js   # stacked
    assert js["probe_batches"] - stats0["probe_batches"] == FETCH_TIMED
    assert counts["join_probe_step"] == 0 and ex._dev is not None
    check = check_join_changes(
        log_, join_reference(src, n_batches, 1000, 10_000), with_sum=True)
    return dict(config="join match-fetch (8b)", batches=n_batches,
                events_per_sec=FETCH_TIMED * FETCH_BATCH / wall,
                wall_s=wall, join_stats=js, launches=counts, check=check,
                stage_s=dict(ex.stage_stats), match_cap=ex._dev["match_cap"],
                store_cap=ex._dev["cap"])


def _store_bytes(st: dict) -> int:
    return sum(int(v.nbytes) for v in st.values())


def _query_keys(other: dict, batch: torch.Tensor, n: int, within: int):
    """The store's (code, ts) keys and the batch's 2n query keys as int64,
    for torch.searchsorted (the probe's bounds in one library call)."""
    def key(c, t):
        return (c.long() << 32) | (t.long() + (1 << 31))

    skey = key(other["code"], other["ts"])
    c, t = batch[0, :n], batch[1, :n]
    return skey, torch.cat([key(c, t - within), key(c, t + within)])


def time_join_kernels(dev, results, captured):
    """Each join kernel on the path's own inputs (one call of each, kept
    by the join paths: the fused call of phase 8's last timed batch, its
    first eviction, the probe + insert of phase 8b's last timed batch and
    the probe-only on the same arguments), held against its plain version
    on them (each into its own output) and timed beside it, its bound and
    a PyTorch yardstick."""
    from hstream_tpu_torch.engine import join_lattice as jl

    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import binding as kb

    missing = [k for k in ("join_probe_insert_step", "join_evict",
                           "join_probe_insert", "extract_touched")
               if k not in captured]
    assert not missing, f"the join paths made no call of {missing}"

    # B6 at the join's shape: the inner lattice's extract of phase 8's
    # last timed batch, on the state it found
    tspec, tstate, tmo = captured["extract_touched"]
    assert lattice.touched_plan(tspec, tmo) == kb.TOUCHED_STAGED
    touched_vs_plain(tspec, tstate, tmo, None, "at the join's shape")
    saved = tstate["touched"].clone()
    work = copy_state(tstate)
    refill, refill_call, _ = kernel_ms(
        lambda: work["touched"].copy_(saved), 20)
    ms, call, srcm = kernel_ms(lambda: (
        work["touched"].copy_(saved),
        lattice.extract_touched(tspec, work, tmo)), 20)
    ms, call = ms - refill, call - refill_call
    plain = kernel_ms(lambda: (
        work["touched"].copy_(saved),
        lattice.extract_touched_ref(tspec, work, tmo)), 3)[0] - refill
    lib = kernel_ms(lambda: torch.nonzero(saved), 20)[0]
    n = int(saved.sum())
    b_ms, b_by = touched_bound(tspec, tstate, n, tmo)
    results["touched_extract_join"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/touched.cu",
        replaces="hstream_tpu/engine/lattice.py:693", max_abs_err=0.0,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, touched=n, max_out=tmo,
        cells=tspec.n_keys * tspec.n_slots, counter="touched_extract",
        paths=[JOIN_TOUCHED])
    log(f"touched_extract at the join's shape (K = {tspec.n_keys}, W = "
        f"{tspec.n_slots}, {n} touched, max_out {tmo}): exact against "
        f"plain; {ms:.4f} ms (plain {plain:.4f}, library nonzero "
        f"{lib:.4f}, bound {b_ms:.4f} by {b_by})")
    del work, saved

    # B17: the fused call of phase 8
    args = captured["join_probe_insert_step"]
    (mine, other, batch, n, within, cutoff, match_cap, nm, spec, state,
     wm_rel, ts_off, progs, feed) = args
    total = step_vs_plain_join(args, "join_probe_step at the path's shapes")
    cap = mine["code"].shape[0]
    out = jl.empty_join_store(cap, nm, dev)
    st = {k: v.clone() for k, v in state.items()}

    def fused():
        jl.join_probe_insert_step(mine, other, batch, n, within, cutoff,
                                  match_cap, nm, spec, st, wm_rel, ts_off,
                                  progs, feed, out=out)

    ms, call, srcm = kernel_ms(fused, 10)
    devt = profiled_calls(fused, 5, "the fused join")
    stages = None if devt is None else _by_stage(devt, 5)
    plain = kernel_ms(lambda: jl.join_probe_insert_step_ref(
        mine, other, batch, n, within, cutoff, match_cap, nm, spec, st,
        wm_rel, ts_off, progs, feed), 2)[0]
    skey, qkey = _query_keys(other, batch, n, within)
    lib = kernel_ms(lambda: torch.searchsorted(skey, qkey), 10)[0]
    state_bytes = sum(int(v.nbytes) for v in state.values())
    nbytes = 2 * _store_bytes(mine) + _store_bytes(other) + \
        int(batch.nbytes) + 2 * state_bytes
    ops = 2 * n * np.log2(cap) + total * (np.log2(batch.shape[1]) + 1)
    b_ms, b_by = bound(nbytes, ops)
    # each redesigned kernel's own bound, bytes once: the insert reads
    # and writes `mine` and reads the batch; the probe reads the batch
    # and writes the feed columns over match_cap (the store windows it
    # searches are keys it reads within that budget)
    feed_plan, nulls_plan, _ = feed
    feed_bytes = match_cap * (4 + 4 + 1 + len(nulls_plan) + sum(
        1 if f[1] == "bool" else 4 for f in feed_plan))
    stage_bounds = {
        "insert": bound(2 * _store_bytes(mine) + int(batch.nbytes), 0)[0],
        "probe": bound(int(batch.nbytes) + feed_bytes, 0)[0]}
    results["join_probe_step"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=cap, n=n, matches=total,
        match_cap=match_cap, stages_ms=stages,
        stage_bounds_ms=stage_bounds)
    log(f"join_probe_step at the path's shapes (store cap {cap}, {n} "
        f"records, {total} matches, match_cap {match_cap}): kernel and "
        f"plain agree; {ms:.4f} ms (plain {plain:.4f}, torch.searchsorted "
        f"of the {2 * n} bounds {lib:.4f}, bound {b_ms:.4f} by {b_by}; by "
        f"stage {json.dumps(stages)}, stage bounds "
        f"{json.dumps(stage_bounds)})")
    del out, st

    # B18: phase 8's first eviction
    left, right, e_cutoff, delta = captured["join_evict"]
    ecap = left["code"].shape[0]
    nl, nr = left["cols"].shape[0], right["cols"].shape[0]
    outs = [jl.empty_join_store(ecap, nl, dev),
            jl.empty_join_store(ecap, nr, dev)]
    gl, gr, gn = jl.join_evict(left, right, e_cutoff, delta, out=outs)
    wl, wr, wn = jl.join_evict_ref(left, right, e_cutoff, delta)
    torch.cuda.synchronize()
    assert stores_equal(wl, gl) and stores_equal(wr, gr) and \
        torch.equal(wn, gn), "join_evict differs at the path's shapes"
    ms, call, srcm = kernel_ms(lambda: jl.join_evict(
        left, right, e_cutoff, delta, out=outs), 10)
    plain = kernel_ms(lambda: jl.join_evict_ref(left, right, e_cutoff,
                                                delta), 2)[0]
    keys = torch.stack([(s["code"].long() << 32) | (s["ts"].long()
                                                    + (1 << 31))
                        for s in (left, right)])
    lib = kernel_ms(lambda: torch.sort(keys, dim=1, stable=True), 10)[0]
    b_ms, b_by = bound(2 * (_store_bytes(left) + _store_bytes(right)),
                       2 * ecap)
    resident = [int((st["code"] < JOIN_SENT).sum()) for st in (left, right)]
    results["join_evict"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=ecap, cutoff=e_cutoff,
        delta=delta, live=gn.tolist(), resident=resident)
    log(f"join_evict of the path's two {ecap}-slot stores (resident "
        f"{resident}, live {gn.tolist()}, delta {delta}): exact against "
        f"plain; {ms:.4f} ms "
        f"(plain {plain:.4f}, torch.sort of both sides' keys {lib:.4f}, "
        f"bound {b_ms:.4f} by {b_by})")
    del outs, gl, gr, wl, wr

    # B15 and B16: phase 8b's probe + insert and its probe alone
    (mine, other, batch, n, within, cutoff, match_cap,
     nm) = captured["join_probe_insert"]
    cap = mine["code"].shape[0]
    out = jl.empty_join_store(cap, nm, dev)
    got_m, got_p = jl.join_probe_insert(mine, other, batch, n, within,
                                        cutoff, match_cap, nm, out=out)
    want_m, want_p = jl.join_probe_insert_ref(mine, other, batch, n,
                                              within, cutoff, match_cap, nm)
    torch.cuda.synchronize()
    assert torch.equal(got_p, want_p) and stores_equal(got_m, want_m), \
        "join_probe_insert differs at the path's shapes"
    total = int(want_p[0, 0])
    ms, call, srcm = kernel_ms(lambda: jl.join_probe_insert(
        mine, other, batch, n, within, cutoff, match_cap, nm, out=out), 10)
    plain = kernel_ms(lambda: jl.join_probe_insert_ref(
        mine, other, batch, n, within, cutoff, match_cap, nm), 2)[0]
    skey, qkey = _query_keys(other, batch, n, within)
    lib = kernel_ms(lambda: torch.searchsorted(skey, qkey), 10)[0]
    nbytes = 2 * _store_bytes(mine) + _store_bytes(other) + \
        int(batch.nbytes) + int(want_p.nbytes)
    b_ms, b_by = bound(nbytes, 2 * n * np.log2(cap)
                       + total * np.log2(batch.shape[1]))
    results["join_probe_insert"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=cap, n=n, matches=total,
        match_cap=match_cap)
    log(f"join_probe_insert at phase 8b's shapes (cap {cap}, {n} records, "
        f"{total} matches, match_cap {match_cap}): exact against plain; "
        f"{ms:.4f} ms (plain {plain:.4f}, torch.searchsorted {lib:.4f}, "
        f"bound {b_ms:.4f} by {b_by})")
    got = jl.join_probe_only(other, batch, n, within, cutoff, match_cap, nm)
    torch.cuda.synchronize()
    assert torch.equal(got, want_p), "join_probe_only differs on the path"
    ms, call, srcm = kernel_ms(lambda: jl.join_probe_only(
        other, batch, n, within, cutoff, match_cap, nm), 10)
    plain = kernel_ms(lambda: jl.join_probe_ref(
        other, batch, n, within, cutoff, match_cap, nm), 2)[0]
    b_ms, b_by = bound(_store_bytes(other) + int(batch.nbytes)
                       + int(want_p.nbytes), 2 * n * np.log2(cap)
                       + total * np.log2(batch.shape[1]))
    results["join_probe_only"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=cap, n=n, matches=total,
        match_cap=match_cap)
    log(f"join_probe_only on the same arguments: exact; {ms:.4f} ms (plain "
        f"{plain:.4f}, bound {b_ms:.4f} by {b_by})")


# ---- phase 3: the packed transport (B10) and the per-slot close (B9) --------

PACK_LAYOUT = (("b", "bool"), ("i", "i32"), ("x", "f32"))


def packed_case(dev):
    """An awkward packed batch and its query: COUNT(*) first (so the
    packer and the unpacker number the NULL masks differently, as the
    reference does), SUM(x), MAX(i), COUNT(b), APPROX_COUNT_DISTINCT(x)
    and TOPK(x, 3) WHERE x > -50 AND NOT b, over bool, i32 and f32
    columns with NULL masks, NaN, +-inf and +-0.0, invalid rows and
    padding past n. Values are multiples of 1/4 below 100, so every SUM
    cell is exact in float32 in any order."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.expr import BinOp, Col, Lit, UnOp
    from hstream_tpu_torch.engine.plan import AggKind as A
    from hstream_tpu_torch.engine.plan import AggSpec
    from hstream_tpu_torch.engine.types import ColumnType, Schema
    from hstream_tpu_torch.engine.window import TumblingWindow

    schema = Schema.of(device=ColumnType.STRING, x=ColumnType.FLOAT,
                       i=ColumnType.INT, b=ColumnType.BOOL)
    aggs = (AggSpec(A.COUNT_ALL, "c"), AggSpec(A.SUM, "s", input=Col("x")),
            AggSpec(A.MAX, "hi", input=Col("i")),
            AggSpec(A.COUNT, "nb", input=Col("b")),
            AggSpec(A.APPROX_COUNT_DISTINCT, "u", input=Col("x")),
            AggSpec(A.TOPK, "t", input=Col("x"), k=TOPK_K))
    where = BinOp("AND", BinOp(">", Col("x"), Lit(-50.0)),
                  UnOp("NOT", Col("b")))
    spec = lattice.LatticeSpec(n_keys=1024,
                               window=TumblingWindow(10_000, grace_ms=0),
                               aggs=aggs, track_touched=True)
    progs = lattice.step_programs(spec, schema, where)
    null_keys = lattice.compile_agg_inputs(spec, schema)[1]
    rng = np.random.default_rng(31)
    n = BATCH - 777
    key = rng.integers(0, N_KEYS, n).astype(np.int32)
    key[::997] = 1024 + 5
    ts = (200_000 + np.sort(rng.integers(0, 30_000, n))).astype(np.int64)
    ts[::1009] = -rng.integers(1, 25_000, ts[::1009].shape[0])
    x = (np.rint(rng.normal(20, 20, n) * 4) / 4).astype(np.float32)
    x = np.clip(x, -99.75, 99.75)
    x[::3001] = np.nan
    x[1::4001] = np.inf
    x[2::5003] = -0.0
    x[3::5009] = 0.0
    cols = {"x": x, "i": rng.integers(-1000, 1000, n).astype(np.int32),
            "b": rng.random(n) < 0.2}
    masks = [None] + [rng.random(n) < 0.02 for _ in aggs[1:]]
    valid = rng.integers(0, 50, n) > 0
    buf = lattice.pack_batch_host(BATCH, n, key, ts, valid, cols, masks,
                                  PACK_LAYOUT)
    return spec, progs, null_keys, torch.from_numpy(buf).to(dev)


def step_packed_plain(spec, state, wm, packed, layout, null_keys, progs):
    """The plain versions of the packed step on the same tensors: the
    plain unpack, the expression programs, the scatter and the top-k
    fold."""
    from hstream_tpu_torch.engine import lattice

    key, ts, valid, cols = lattice.unpack_batch(packed, layout, null_keys)
    valid = valid.clone()
    for prog, name in progs:
        r = prog(cols)
        if name is None:
            valid.logical_and_(r)
        else:
            cols[name] = r
    lattice.scatter_step_ref(spec, state, wm, key, ts, valid, cols)
    lattice.topk_step_ref(spec, state, wm, key, ts, valid, cols)


def headline_packed(dev):
    """Config 1's headline batch as the packed transport carries it:
    int32 [4, 2^20] (key, ts, flags, temp), no NULLs."""
    from hstream_tpu_torch.engine import lattice

    rng = np.random.default_rng(3)
    kids = rng.integers(0, N_KEYS, BATCH).astype(np.int32)
    ts = 10_000 + (np.arange(BATCH, dtype=np.int64) * 200) // BATCH
    temps = (np.rint(rng.normal(20, 5, BATCH) * 10).astype(np.float32)
             * np.float32(0.1))
    buf = lattice.pack_batch_host(BATCH, BATCH, kids, ts, None,
                                  {"temp": temps}, [None, None, None],
                                  (("temp", "f32"),))
    return torch.from_numpy(buf).to(dev)


def check_unpack(dev, results):
    """B10: the unpack kernel against the plain unpack, and the packed
    step (unpack, expression, scatter, top-k kernels) against the plain
    versions, on the awkward batch; then both timed at config 1's
    headline [4, 2^20]."""
    from hstream_tpu_torch.engine import lattice

    spec, progs, null_keys, packed = packed_case(dev)
    assert null_keys == (None,) + tuple(f"__null_a{i}" for i in range(1, 6))
    got = lattice.unpack(packed, PACK_LAYOUT, null_keys)
    want = lattice.unpack_batch(packed, PACK_LAYOUT, null_keys)
    torch.cuda.synchronize()
    for g, w, what in zip(got[:3], want[:3], ("key", "ts", "valid")):
        assert torch.equal(g, w), f"unpack: {what} differs"
    assert got[0].data_ptr() == packed[0].data_ptr()
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        assert same_bits(got[3][k], want[3][k]), f"unpack: {k} differs"
    assert got[3]["x"].data_ptr() == packed[5].data_ptr()
    assert not bool(got[2][BATCH - 777:].any()), "padding is valid"
    # the reference's numbering: mask j lands in bit 1 + j, read from
    # bit j; the last aggregate's mask is never read
    assert torch.equal(got[3]["__null_a1"], ((packed[2] >> 1) & 1) != 0)
    assert torch.equal(got[3]["__null_a2"], ((packed[2] >> 2) & 1) != 0)
    wm = 205_000
    state = lattice.init_state(spec, dev)
    for rnd in range(2):
        a, b = copy_state(state), copy_state(state)
        lattice.step_packed(spec, a, wm, packed, PACK_LAYOUT, null_keys,
                            progs)
        step_packed_plain(spec, b, wm, packed, PACK_LAYOUT, null_keys, progs)
        torch.cuda.synchronize()
        for k in b:
            assert same_bits(a[k], b[k], k), f"step_packed round {rnd}: {k}"
        state = b
    assert int(state["count"].sum()) > 0
    # timed at the main path's shapes: config 1's headline batch
    spec1 = make_spec(1)
    head = headline_packed(dev)
    lay1, nk1 = (("temp", "f32"),), (None, "__null_a1", "__null_a2")
    h_got = lattice.unpack(head, lay1, nk1)
    h_want = lattice.unpack_batch(head, lay1, nk1)
    torch.cuda.synchronize()
    assert torch.equal(h_got[2], h_want[2])
    for k in h_want[3]:
        assert same_bits(h_got[3][k], h_want[3][k]), f"headline unpack {k}"
    ms, call, src = kernel_ms(lambda: lattice.unpack(head, lay1, nk1), 50)
    plain = kernel_ms(lambda: lattice.unpack_batch(head, lay1, nk1), 50)[0]
    flags = head[2]

    def library():
        return ((flags & 1) != 0, ((flags >> 1) & 1) != 0,
                ((flags >> 2) & 1) != 0)

    lib_ms = kernel_ms(library, 50)[0]
    # reads the flags row once, writes valid and two one-byte masks
    b_ms, b_by = bound(BATCH * (4 + 3), BATCH * 6)
    st = lattice.init_state(spec1, dev)
    step_ms, step_call, _ = kernel_ms(lambda: lattice.step_packed(
        spec1, st, -1, head, lay1, nk1), 30)
    results["unpack"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/unpack.cu",
        replaces="hstream_tpu/engine/lattice.py:374",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, call_ms=call, ms_source=src,
        step_packed_ms=step_ms, step_packed_call_ms=step_call)
    log(f"unpack: exact (bool, i32, f32, NULL masks behind COUNT(*), "
        f"padding); step_packed exact on every plane; {ms:.4f} ms (plain "
        f"{plain:.4f}, library {lib_ms:.4f}, bound {b_ms:.5f}); "
        f"step_packed {step_ms:.4f} ms device, {step_call:.4f} ms call "
        f"at [4, 2^20]")


def check_slot_close(dev, results, states, chg):
    """B9: the per-slot extract and reset against their plain versions on
    every slot of config 1's, config 2's and the changelog query's
    planes; then timed on one filled slot of config 1's headline
    lattice."""
    from hstream_tpu_torch.engine import lattice

    cspec, progs, (key, ts, valid, cols), _ = chg
    cstate = lattice.init_state(cspec, dev)
    lattice.step_decoded(cspec, cstate, -1, key, ts, valid.clone(),
                         dict(cols), progs)
    cases = [(make_spec(1), states[1]), (make_spec(2), states[2]),
             (cspec, cstate)]
    n = 0
    for spec, state in cases:
        for slot in range(spec.n_slots):
            got = lattice.extract_slot(spec, state, slot)
            want = lattice.extract_slot_ref(spec, state, slot)
            a, b = copy_state(state), copy_state(state)
            lattice.reset_slot(spec, a, slot)
            lattice.reset_slot_ref(spec, b, slot)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"extract_slot {slot} differs"
            for k in b:
                assert torch.equal(a[k], b[k]), f"reset_slot {slot}: {k}"
            n += 1
    # timed at the main path's shape: config 1, K = 1024, one filled slot
    spec = make_spec(1)
    st = lattice.init_state(spec, dev)
    head = headline_packed(dev)
    lattice.step_packed(spec, st, -1, head, (("temp", "f32"),),
                        (None, "__null_a1", "__null_a2"))
    slot = int(torch.nonzero(st["count"].sum(0))[0])
    ms, call, src = kernel_ms(lambda: lattice.extract_slot(spec, st, slot),
                              50)
    plain = kernel_ms(lambda: lattice.extract_slot_ref(spec, st, slot),
                      10)[0]
    K = spec.n_keys
    rows = 2 + lattice.out_rows(spec)
    b_ms, b_by = bound(K * (4 + 4 + 1024) + 4 + rows * K * 4, K * 1024 * 4)
    work = copy_state(st)
    rms, rcall, rsrc = kernel_ms(lambda: lattice.reset_slot(spec, work,
                                                            slot), 50)
    rplain = kernel_ms(lambda: lattice.reset_slot_ref(spec, work, slot),
                       10)[0]
    rb_ms, rb_by = bound(K * (4 + 1 + 4 + 1024) + 4, 0)
    results["extract_slot"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/close.cu",
        replaces="hstream_tpu/engine/lattice.py:529",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src)
    results["reset_slot"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/close.cu",
        replaces="hstream_tpu/engine/lattice.py:547",
        max_abs_err=0.0, ms=rms, plain_ms=rplain, bound_ms=rb_ms,
        bound_by=rb_by, library_ms=None, call_ms=rcall, ms_source=rsrc)
    log(f"extract_slot / reset_slot: {n} slots of three lattices exact; "
        f"extract {ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.5f}), reset "
        f"{rms:.4f} ms (plain {rplain:.4f}, bound {rb_ms:.5f})")


# ---- phase 9: B10 + B9 through CompiledLattice and the executor -------------

def compiled_path(dev) -> dict:
    """Phase 9a: config 1's stream (1000 keys, 101 batches of 2^20) packed
    by lattice.pack_batch_host into two pinned buffers, uploaded, stepped
    by compiled(...).step (the unpack kernel, then the scatter), and each
    window the watermark closes closed by extract_slot then reset_slot
    (the legacy loop of tests/test_close_batched.py:75-90); rows against
    phase 4's numpy reference."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.types import ColumnType, Schema

    spec = make_spec(1)
    schema = Schema.of(device=ColumnType.STRING, temp=ColumnType.FLOAT)
    layout = (("temp", "f32"),)
    fns = lattice.compiled(spec, schema, None,
                           lattice.touched_max_out(spec, BATCH), layout)
    assert fns.null_keys == (None, "__null_a1", "__null_a2")
    state = lattice.init_state(spec, dev)
    size = adv = spec.window.advance_ms
    W = spec.n_slots
    epoch = BASE_TS - BASE_TS % adv - adv   # the executor's anchor
    src = Batches(seed=1)
    per_key = src.per_key()
    pinned = [torch.empty((3 + len(layout), BATCH), dtype=torch.int32,
                          pin_memory=True) for _ in range(2)]
    copied: list = [None, None]
    open_: set[int] = set()
    rows: list = []
    wm = -1
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(MAIN_BATCHES):
        kids, ts, temps = src.get(b)
        i = b % 2
        if copied[i] is not None:
            copied[i].synchronize()       # the buffer's last upload is done
        lattice.pack_batch_host(BATCH, BATCH, kids, ts - epoch, None,
                                {"temp": temps}, [None, None, None], layout,
                                out=pinned[i].numpy())
        packed = pinned[i].to(dev, non_blocking=True)
        copied[i] = torch.cuda.Event()
        copied[i].record()
        state = fns.step(state, wm - epoch if wm >= 0 else -1, packed)
        lo, hi = int(ts.min()), int(ts.max())
        open_.update(range(lo - lo % adv, hi - hi % adv + 1, adv))
        wm = max(wm, hi)
        for start in sorted(s for s in open_ if s + size <= wm):
            open_.discard(start)
            slot = ((start - epoch) // adv) % W
            out = fns.extract_slot(state, slot).cpu().numpy()
            state = fns.reset_slot(state, slot)
            count, ws, outs = lattice.unpack_extract_rows(spec, out)
            assert (ws == start - epoch).all(), "slot_start differs"
            for kid in np.nonzero(count > 0)[0]:
                rows.append({"device": f"d{kid}", "winStart": start,
                             "winEnd": start + size, "cnt": int(count[kid]),
                             "total": float(outs["total"][kid]),
                             "uniq": int(np.rint(outs["uniq"][kid]))})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_windows = check_rows(1, spec, rows, per_key, dev)
    assert counts["unpack"] == counts["scatter_aggregate"] == MAIN_BATCHES, \
        counts
    assert counts["extract_slot"] == counts["reset_slot"] == n_windows, \
        counts
    for k in ("wire_decode", "fused_close", "reset_close", "expression",
              "topk_fold", "touched_extract"):
        assert counts[k] == 0, counts
    return dict(config="CompiledLattice, config 1 (9a)",
                events_per_sec=MAIN_BATCHES * BATCH / wall, wall_s=wall,
                windows_checked=n_windows, rows=len(rows), launches=counts)


def per_slot_path(dev) -> dict:
    """Phase 9b: config 2 (HOP(60 s, 10 s), several windows due per
    cycle) through IngestPipeline with `_fused_close_ok = False`: every
    close cycle takes the per-slot close (B9), two launches and one
    fetch per window; rows against numpy."""
    from hstream_tpu_torch.engine import (
        AggregateNode,
        ColumnType,
        IngestPipeline,
        QueryExecutor,
        Schema,
        SourceNode,
    )
    from hstream_tpu_torch.engine.expr import Col

    spec = make_spec(2)
    schema = Schema.of(device=ColumnType.STRING, temp=ColumnType.FLOAT)
    node = AggregateNode(child=SourceNode("sensors", schema),
                         group_keys=[Col("device")], window=spec.window,
                         aggs=list(spec.aggs))
    ex = QueryExecutor(node, schema, emit_changes=False, initial_keys=1024,
                       batch_capacity=BATCH)
    assert ex.device == dev, ex.device
    ex._fused_close_ok = False
    for k in range(N_KEYS):
        ex.key_id_for((f"d{k}",))
    src = Batches(seed=2)
    per_key = src.per_key()
    pipe = IngestPipeline(ex, depth=4, workers=2)
    zero_counts()
    rows: list = []
    try:
        t0 = time.perf_counter()
        for b in range(MAIN_BATCHES):
            kids, ts, temps = src.get(b)
            rows.extend(pipe.submit(kids, ts, {"temp": temps}))
        rows.extend(pipe.flush())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipe.close()
    # a watermark jump: the six windows still open fall due together
    n = N_KEYS
    rows.extend(ex.process_columnar(
        np.arange(n, dtype=np.int32), np.full(n, BASE_TS + 200_000, np.int64),
        {"temp": np.full(n, np.float32(21.5))}))
    st = dict(ex.close_stats)
    counts = launch_counts()
    n_windows = check_rows(2, spec, rows, per_key, dev)
    closed = counts["extract_slot"]
    assert closed == counts["reset_slot"] >= n_windows, counts
    assert st["close_dispatches"] == 2 * closed, (st, counts)
    assert st["close_fetches"] == closed, (st, counts)
    assert closed > st["close_cycles"] >= 1, st    # several due per cycle
    assert counts["fused_close"] == counts["reset_close"] == 0, counts
    assert ex._fused_close_ok is False and ex.device_fallbacks == 0
    return dict(config="per-slot close, config 2 (9b)",
                events_per_sec=MAIN_BATCHES * BATCH / wall, wall_s=wall,
                windows_checked=n_windows, windows_closed=closed,
                rows=len(rows), close_stats=st, launches=counts)


# ---- phase 10: SQL text -> executor -> snapshot -> restore -> continue -------

SNAP_SQL = ("CREATE STREAM agg AS SELECT device, COUNT(*), SUM(temp), "
            "APPROX_COUNT_DISTINCT(temp) FROM sensors GROUP BY device, "
            "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND "
            "EMIT CHANGES;")
SNAP_AT = 25                 # batches before the snapshot
SESS_SNAP_SQL = ("CREATE VIEW sess AS SELECT user, APPROX_QUANTILE(lat, 0.5) "
                 "AS p50, APPROX_QUANTILE(lat, 0.99) AS p99 FROM s GROUP BY "
                 "user, SESSION (INTERVAL 5 SECOND) GRACE BY INTERVAL 0 "
                 "SECOND;")
SNAP_SESS_USERS = 10_000
SNAP_SESS_BATCHES = 8
SNAP_JOIN_BATCHES = 8
SNAP_SIDE_AT = 4


class WindowLog:
    """Phase 10's changelog rows as numpy columns, in emission order."""

    COLS = ("COUNT(*)", "SUM(temp)", "APPROX_COUNT_DISTINCT(temp)")

    def __init__(self):
        self.parts: list[tuple] = []

    def add(self, out) -> None:
        from hstream_tpu_torch.common.columnar import ColumnarEmit

        if not len(out):
            return
        if not isinstance(out, ColumnarEmit):
            out = ColumnarEmit({k: [r[k] for r in out] for k in out[0]},
                               len(out))
        c = out.cols
        self.parts.append((
            np.array([int(d[1:]) for d in c["device"]], np.int64),
            np.asarray(c["winStart"], np.int64),
            np.asarray(c[self.COLS[0]], np.int64),
            np.asarray(c[self.COLS[1]], np.float64),
            np.asarray(c[self.COLS[2]], np.int64)))

    def columns(self):
        return tuple(np.concatenate([p[i] for p in self.parts])
                     for i in range(5))


def snapshot_window_run(dev, plan, src, restore_at: int | None) -> dict:
    """Phase 10 (a, b): the lowered plan's executor through IngestPipeline
    over config 1's stream; with `restore_at`, the executor is captured
    after that many batches (the changelog flushed first), stepped once
    more (the capture must not follow), serialized, sealed, opened and
    restored into a fresh executor on the card, which continues."""
    from hstream_tpu_torch.engine import (IngestPipeline, capture_executor,
                                          open_blob, restore_executor,
                                          seal_blob, serialize_capture)
    from hstream_tpu_torch.sql import make_executor

    sample = [{"device": "d0", "temp": 1.0}]
    ex = make_executor(plan, sample_rows=sample, initial_keys=1024,
                       batch_capacity=BATCH)
    assert ex.device == dev and ex.emit_changes, ex.device
    for k in range(N_KEYS):
        ex.key_id_for((f"d{k}",))
    log_ = WindowLog()
    timing: dict = {}
    pipe = IngestPipeline(ex, depth=4, workers=2)
    zero_counts()
    try:
        for b in range(MAIN_BATCHES):
            if b == restore_at:
                log_.add(pipe.flush())
                pipe.close()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                meta, arrays = capture_executor(ex, {"batches": b})
                torch.cuda.synchronize()
                timing["capture_s"] = time.perf_counter() - t0
                # the old executor steps on: its planes change in place,
                # the capture's clones must not
                kids, ts, temps = src.get(b)
                ex.process_columnar(kids, ts, {"temp": temps})
                t0 = time.perf_counter()
                blob = serialize_capture(meta, arrays)
                timing["serialize_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                sealed = seal_blob(blob)
                timing["seal_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                ex, extra = restore_executor(plan, open_blob(sealed),
                                             batch_capacity=BATCH)
                torch.cuda.synchronize()
                timing["restore_s"] = time.perf_counter() - t0
                assert extra == {"batches": b} and ex.device == dev
                timing["blob_bytes"] = len(sealed)
                t0 = time.perf_counter()
                log_.add(ex.process_columnar(kids, ts, {"temp": temps}))
                torch.cuda.synchronize()
                timing["first_batch_s"] = time.perf_counter() - t0
                pipe = IngestPipeline(ex, depth=4, workers=2)
                continue
            kids, ts, temps = src.get(b)
            log_.add(pipe.submit(kids, ts, {"temp": temps}))
        log_.add(pipe.flush())
        torch.cuda.synchronize()
    finally:
        pipe.close()
    return dict(log=log_, timing=timing, launches=launch_counts(),
                close_stats=dict(ex.close_stats), ex=ex)


def snapshot_path(dev) -> dict:
    """Phase 10 (a, b): SQL text -> stream_codegen -> make_executor at full
    width; at batch 25, with the window open, flush_changes, capture,
    serialize, seal, open, restore into a fresh executor, continue to
    batch 101. The changelog after the restore equals an uninterrupted
    run's row for row (counts and HLL exact, SUM within twice the order
    bound: each side within it of the true sum); the final change of
    every (key, window) against numpy."""
    from hstream_tpu_torch.sql import plans, stream_codegen

    plan = stream_codegen(SNAP_SQL)
    assert isinstance(plan, plans.CreateBySelectPlan), type(plan)
    plan = plan.select
    src = Batches(seed=1)
    per_key = src.per_key()
    base = snapshot_window_run(dev, plan, src, None)
    run = snapshot_window_run(dev, plan, src, SNAP_AT)
    k0, w0, c0, s0, u0 = base["log"].columns()
    k1, w1, c1, s1, u1 = run["log"].columns()
    # one change per key per batch (each 200 ms batch lies in one window)
    assert len(k0) == len(k1) == MAIN_BATCHES * N_KEYS, (len(k0), len(k1))
    assert (k0 == k1).all() and (w0 == w1).all(), "rows out of order"
    assert (c0 == c1).all(), "counts differ after the restore"
    assert (u0 == u1).all(), "HLL estimates differ after the restore"
    # batch b's changes are rows [1000 b, 1000 (b + 1)), keys ascending,
    # all in one window; sum|x| of each running value from numpy
    batch_of = np.arange(len(k0)) // N_KEYS
    abs_cum = np.zeros(len(k0))
    run_abs: dict = {}
    for b in range(MAIN_BATCHES):
        sel = slice(b * N_KEYS, (b + 1) * N_KEYS)
        assert (k0[sel] == np.arange(N_KEYS)).all()
        assert (w0[sel] == w0[sel][0]).all()
        win = int(w0[sel][0])
        run_abs[win] = run_abs.get(win, 0.0) + per_key[b % N_UNIQUE]["abs"]
        abs_cum[sel] = run_abs[win]
    # each run within 2 n 2^-24 sum|x| of the exact running sum
    lim = 2 * (2 * c0 * U * abs_cum)
    assert (np.abs(s0 - s1) <= lim).all(), "SUM beyond the order bound"
    after = batch_of >= SNAP_AT
    # the final change per (key, window) against numpy (phase 4's check)
    last: dict = {}
    for i in range(len(k1)):
        last[(k1[i], w1[i])] = i
    final = [{"device": f"d{k1[i]}", "winStart": int(w1[i]),
              "winEnd": int(w1[i]) + 10_000, "cnt": int(c1[i]),
              "total": float(s1[i]), "uniq": int(u1[i])}
             for i in last.values()]
    n_windows = check_rows(1, make_spec(1), final, per_key, dev)
    counts = run["launches"]
    for k in ("wire_decode", "scatter_aggregate", "touched_extract",
              "reset_close"):
        assert counts[k] > 0, counts
    assert counts["fused_close"] == 0 and run["ex"].device_fallbacks == 0
    return dict(config="SQL -> snapshot -> restore, config 1 (10a-b)",
                rows_after_restore=int(after.sum()),
                windows_checked=n_windows, snapshot=run["timing"],
                close_stats=run["close_stats"], launches=counts,
                uninterrupted_launches=base["launches"])


def _session_rows(rows) -> list:
    return sorted((r["user"], r["winStart"], r["winEnd"], r["p50"],
                   r["p99"]) for r in rows)


def session_snapshot_run(plan, src, restore_at: int | None):
    from hstream_tpu_torch.engine import (open_blob, restore_executor,
                                          seal_blob, snapshot_executor)
    from hstream_tpu_torch.sql import make_executor

    ex = make_executor(plan, sample_rows=[{"user": "u0", "lat": 1.0}])
    rows: list = []
    info: dict = {}
    for b in range(SNAP_SESS_BATCHES):
        if b == restore_at:
            assert ex._dev is not None and not ex.has_pending_closes()
            t0 = time.perf_counter()
            blob = seal_blob(snapshot_executor(ex))
            info["snapshot_s"] = time.perf_counter() - t0
            info["blob_bytes"] = len(blob)
            info["open_sessions"] = int(ex._dev["mir_live"].sum())
            t0 = time.perf_counter()
            ex, _ = restore_executor(plan, open_blob(blob))
            info["restore_s"] = time.perf_counter() - t0
            assert ex._dev is None   # the host view, migrated on next batch
        ts, cols = src.get(b)
        rows.extend(ex.process_columnar(ts, cols))
        if b == restore_at:
            assert ex._dev is not None, "the device path did not activate"
    # a closer far past every session's end closes them all
    ts_end = int(max(t.max() for t in src.ts[:SNAP_SESS_BATCHES]))
    rows.extend(ex.process_columnar(
        np.array([ts_end + 60_000], np.int64),
        {"user": np.array(["closer"]), "lat": np.ones(1, np.float32)}))
    rows.extend(ex.drain_closed())
    assert ex._dev is not None and ex.device_fallbacks == 0
    return rows, info


def join_snapshot_run(plan, src, restore_at: int | None):
    from hstream_tpu_torch.engine import (open_blob, restore_executor,
                                          seal_blob, snapshot_executor)
    from hstream_tpu_torch.sql import make_executor

    ex = make_executor(plan, sample_rows=[{"k": "k0", "x": 1.0}],
                       batch_capacity=4 * FETCH_BATCH)
    log_ = ChangeLog(src.keys)
    info: dict = {}
    for b in range(SNAP_JOIN_BATCHES):
        if b == restore_at:
            log_.add(ex.flush_changes())
            assert ex._dev is not None and not ex.has_pending_changes()
            t0 = time.perf_counter()
            blob = seal_blob(snapshot_executor(ex))
            info["snapshot_s"] = time.perf_counter() - t0
            info["blob_bytes"] = len(blob)
            t0 = time.perf_counter()
            ex, _ = restore_executor(plan, open_blob(blob),
                                     batch_capacity=4 * FETCH_BATCH)
            assert ex._dev is None   # host stores, migrated on activation
            info["restore_s"] = time.perf_counter() - t0
        ts, cols, side = src.get(b)
        log_.add(ex.process_columnar(ts, cols, stream=side))
    log_.add(ex.flush_changes())
    torch.cuda.synchronize()
    assert ex._dev is not None, "the join's device path did not re-activate"
    assert ex.device_fallbacks == 0
    return log_, info


def snapshot_side_paths(dev) -> dict:
    """Phase 10c: a session and a join snapshot, each from SQL text; the
    restored executors re-activate on the card and their rows equal an
    uninterrupted run's. Cut for the JSON meta's size (a session's 512
    histogram bins, a join store's entry rows go into it as lists; at
    config 4's and config 5's full widths that is hundreds of MB): the
    session over 10,000 user slots (config 4: 100,000) for 8 batches of
    2^20, snapshot after batch 4, then a closer; the join at phase 8b's
    size (2^16-record batches over 32,000 keys, not config 5's 2^20 over
    512,000), 8 batches, snapshot after batch 4."""
    from hstream_tpu_torch.sql import plans, stream_codegen

    plan = stream_codegen(SESS_SNAP_SQL)
    assert isinstance(plan, plans.CreateViewPlan), type(plan)
    plan = plan.select
    src = SessionStream(seed=13, n_batches=SNAP_SESS_BATCHES,
                        users=SNAP_SESS_USERS)
    zero_counts()
    want, _ = session_snapshot_run(plan, src, None)
    got, sinfo = session_snapshot_run(plan, src, SNAP_SIDE_AT)
    counts = launch_counts()
    assert len(got) == len(want) > 0
    assert _session_rows(got) == _session_rows(want), "session rows differ"
    jplan = stream_codegen(JOIN_FETCH_SQL)
    jsrc = JoinStream(7, FETCH_BATCH, FETCH_KEYS, with_x=True)
    jwant, _ = join_snapshot_run(jplan, jsrc, None)
    jgot, jinfo = join_snapshot_run(jplan, jsrc, SNAP_SIDE_AT)
    jcounts = launch_counts()
    kw, ww, cw, sw = jwant.final()
    kg, wg, cg, sg = jgot.final()
    assert (kw == kg).all() and (ww == wg).all() and (cw == cg).all(), \
        "join finals differ"
    check = check_join_changes(
        jgot, join_reference(jsrc, SNAP_JOIN_BATCHES, 1000, 10_000),
        with_sum=True)
    # record mode on the card (the step kernel), a batch each
    assert counts["session_step"] + counts["session_merge"] >= \
        2 * SNAP_SESS_BATCHES and counts["session_extract"] > 0, counts
    assert jcounts["join_probe_insert"] > 0, jcounts
    return dict(config="session + join snapshots (10c)",
                session=dict(sessions_checked=len(got), **sinfo),
                join=dict(check=check, **jinfo), launches=jcounts)


# ---- phase 11: from the durable log ------------------------------------------

LOG_SQL = ("CREATE VIEW sensor_stats AS SELECT device, COUNT(*), "
           "SUM(LOG10(ABS(temp) + 1)), AVG(EXP(temp / 50)), "
           "MAX(ROUND(temp)), MIN(CEIL(temp)) FROM sensors WHERE "
           "SQRT(ABS(temp)) > 4.0 GROUP BY device, TUMBLING (INTERVAL 10 "
           "SECOND) GRACE BY INTERVAL 0 SECOND;")
LOG_AGGS = ("COUNT(*)", "SUM(LOG10(ABS(temp) + 1))", "AVG(EXP(temp / 50))",
            "MAX(ROUND(temp))", "MIN(CEIL(temp))")
LOG_SEED = 11                # the stream's Batches seed
LOG_BLOCKS = 16              # columnar records of 2^16 rows per batch
LOG_BATCHES = 56             # the first window closes at batch 50
LOG_RESTART_AT = 25
LOG_JSON_BATCHES = 8
LOG_JSON_ROWS = 1 << 16
LOG_JSON_MS = 1200           # the last JSON batch crosses the 20 s end
LOG_PROFILE = (30, 38)       # the uninterrupted run's profiled batches


class LogStream:
    """Phase 11's producer: config 1's stream (Batches: 1000 keys,
    one-decimal temps, 200 ms of stream per 2^20-record batch) as
    columnar records, then JSON records (records.build_record) of the
    next 9.6 s. Each unique batch's blocks are encoded once by
    encode_columnar with their timestamps zeroed; a batch's payload is a
    copy with its timestamps written in (the layout is MAGIC | u32
    header length | header | ts i64[n] | columns), which init checks
    against encode_columnar for one block."""

    def __init__(self, seed: int):
        from hstream_tpu_torch.common import columnar, records

        self.src = Batches(seed)
        self.names = np.array([f"d{k}" for k in range(N_KEYS)])
        self.block = BATCH // LOG_BLOCKS
        self.templates = []
        for kids, temps in zip(self.src.kids, self.src.temps):
            row = []
            for q in range(LOG_BLOCKS):
                sl = slice(q * self.block, (q + 1) * self.block)
                p = columnar.encode_columnar(
                    np.zeros(self.block, np.int64),
                    {"device": self.names[kids[sl]], "temp": temps[sl]})
                hlen = int(np.frombuffer(p, np.uint32, 1,
                                         len(columnar.MAGIC))[0])
                row.append((p, len(columnar.MAGIC) + 4 + hlen))
            self.templates.append(row)
        kids, ts, temps = self.src.get(3)
        assert self.block_payload(3, 1, ts) == columnar.encode_columnar(
            ts[self.block:2 * self.block],
            {"device": self.names[kids[self.block:2 * self.block]],
             "temp": temps[self.block:2 * self.block]})
        rng = np.random.default_rng(seed + 100)
        t0 = BASE_TS + LOG_BATCHES * STREAM_MS_PER_BATCH
        self.json = []
        for j in range(LOG_JSON_BATCHES):
            kids = rng.integers(0, N_KEYS, LOG_JSON_ROWS).astype(np.int32)
            temps = (np.rint(rng.normal(20.0, 5.0, LOG_JSON_ROWS) * 10)
                     .astype(np.float32) * np.float32(0.1))
            ts = (t0 + j * LOG_JSON_MS + (np.arange(
                LOG_JSON_ROWS, dtype=np.int64) * LOG_JSON_MS)
                // LOG_JSON_ROWS)
            self.json.append((kids, ts, temps))
        t = time.perf_counter()
        self.json_records = [
            [records.build_record({"device": self.names[k], "temp": float(v)},
                                  publish_time_ms=int(s)).SerializeToString()
             for k, s, v in zip(kids.tolist(), ts.tolist(), temps.tolist())]
            for kids, ts, temps in self.json]
        self.json_build_s = time.perf_counter() - t

    def block_payload(self, b: int, q: int, ts: np.ndarray) -> bytes:
        p, off = self.templates[b % N_UNIQUE][q]
        buf = bytearray(p)
        buf[off:off + 8 * self.block] = np.ascontiguousarray(
            ts[q * self.block:(q + 1) * self.block], np.int64).tobytes()
        return bytes(buf)


def log_append(ls: LogStream, uri: str) -> dict:
    """Append the stream: each batch one append of LOG_BLOCKS RAW records
    (records.wrap_raw_record, the framed append's record shape) at the
    batch's last timestamp, then each JSON batch one append."""
    from hstream_tpu_torch.common import records
    from hstream_tpu_torch.store import StreamApi, open_store

    store = open_store(uri)
    try:
        sid = StreamApi(store).create_stream("sensors")
        produce = append = 0.0
        for b in range(LOG_BATCHES):
            t = time.perf_counter()
            _, ts, _ = ls.src.get(b)
            recs = [records.wrap_raw_record(ls.block_payload(b, q, ts),
                                            int(ts[(q + 1) * ls.block - 1]))
                    for q in range(LOG_BLOCKS)]
            t1 = time.perf_counter()
            store.append_batch(sid, recs, append_time_ms=int(ts[-1]))
            t2 = time.perf_counter()
            produce += t1 - t
            append += t2 - t1
        t = time.perf_counter()
        for recs, (_, ts, _) in zip(ls.json_records, ls.json):
            store.append_batch(sid, recs, append_time_ms=int(ts[-1]))
        json_append = time.perf_counter() - t
    finally:
        store.close()
    root = uri[len("file://"):]
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(root) for f in fs)
    return dict(sid=sid, produce_s=produce, append_s=append,
                json_append_s=json_append, store_bytes=nbytes)


def log_batch(ex, got, luts: dict):
    """One appended batch read back -> (key ids, ts, {"temp"}): the
    columnar records' blocks (columnar.decode_columnar_nulls) or the JSON
    records (jsondec.decode_batch), a key id per distinct device string
    through each block's dictionary, as the server's query task does
    (hstream_tpu/server/tasks.py _columnar_key_ids, _device_columns)."""
    from hstream_tpu_torch.common import columnar, jsondec, records

    def keys(ids, names):
        k = tuple(names)
        lut = luts.get(k)
        if lut is None:
            lut = luts[k] = np.array([ex.key_id_for((s,)) for s in names],
                                     np.int32)
        return lut[ids]

    views = [records.peek_columnar_payload(p) for p in got.payloads]
    if all(v is not None for v in views):
        parts = []
        for v in views:
            ts, cols, nulls = columnar.decode_columnar_nulls(v)
            assert nulls is None and cols["temp"][0] == "f32"
            parts.append((keys(cols["device"][1], cols["device"][2]), ts,
                          cols["temp"][1]))
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))
    dts = np.full(len(got.payloads), got.append_time_ms, np.int64)
    ts, cls, cols, nulls = jsondec.decode_batch(list(got.payloads), dts)
    assert (cls == jsondec.CLS_JSON).all() and not nulls["temp"].any()
    kind, ids, names = cols["device"]
    assert kind == "str"
    return keys(ids, names), ts, np.asarray(cols["temp"][1], np.float32)


def log_run(dev, uri: str, sid: int, ckp: str, name: str,
            restart_at: int | None) -> dict:
    """Read the stream back from `name`'s checkpoint into LOG_SQL's query
    through IngestPipeline; with `restart_at`, flush, write the
    checkpoint, snapshot the query, close and reopen the store, restore
    and resume there; without it, profile the LOG_PROFILE batches."""
    from hstream_tpu_torch.engine import (IngestPipeline, open_blob,
                                          restore_executor, seal_blob,
                                          snapshot_executor)
    from hstream_tpu_torch.sql import make_executor, stream_codegen
    from hstream_tpu_torch.store import (CheckpointedReader,
                                         FileCheckpointStore, open_store)

    plan = stream_codegen(LOG_SQL).select

    def reader(store):
        rd = CheckpointedReader(name, store.new_reader(),
                                FileCheckpointStore(ckp))
        rd.set_timeout(0)
        rd.start_reading_from_checkpoint(sid)
        return rd

    store = open_store(uri)
    ex = make_executor(plan, sample_rows=[{"device": "d0", "temp": 1.0}],
                       initial_keys=1024, batch_capacity=BATCH)
    assert ex.device == dev and not ex.emit_changes, ex.device
    ex.defer_close_decode = True
    rd, rows, luts = reader(store), [], {}
    sec = dict(read_s=0.0, decode_s=0.0, json_decode_s=0.0)
    pipe = IngestPipeline(ex, depth=4, workers=2)
    timing: dict = {}
    lsn = None

    def step(b: int) -> None:
        nonlocal lsn
        t = time.perf_counter()
        (got,) = rd.read(1)          # one append: readers count batches
        t1 = time.perf_counter()
        kids, ts, temps = log_batch(ex, got, luts)
        t2 = time.perf_counter()
        sec["read_s"] += t1 - t
        key = "decode_s" if b < LOG_BATCHES else "json_decode_s"
        sec[key] += t2 - t1
        lsn = got.lsn
        rows.extend(pipe.submit(kids, ts, {"temp": temps}))

    zero_counts()
    try:
        t0 = time.perf_counter()
        for b in range(LOG_BATCHES + LOG_JSON_BATCHES):
            if b == restart_at:
                t = time.perf_counter()
                rows.extend(pipe.flush())
                rows.extend(ex.drain_closed())
                pipe.close()
                rd.write_checkpoints({sid: lsn})
                sealed = seal_blob(snapshot_executor(ex, {"lsn": lsn}))
                store.close()
                store = open_store(uri)
                ex, extra = restore_executor(plan, open_blob(sealed),
                                             batch_capacity=BATCH)
                assert extra == {"lsn": lsn} and ex.device == dev, extra
                ex.defer_close_decode = True
                rd = reader(store)
                pipe = IngestPipeline(ex, depth=4, workers=2)
                torch.cuda.synchronize()
                timing.update(restart_s=time.perf_counter() - t,
                              blob_bytes=len(sealed))
            if restart_at is None and b == LOG_PROFILE[0]:
                def window():
                    t = time.perf_counter()
                    for k in range(*LOG_PROFILE):
                        step(k)
                    rows.extend(pipe.flush())
                    torch.cuda.synchronize()
                    return time.perf_counter() - t

                wall, devt = profiled(window)
                timing.update(profile_batches=LOG_PROFILE[1] - LOG_PROFILE[0],
                              profile_wall_s=wall,
                              device_busy_share=sum(devt.values()) / 1e6
                              / wall)
            if restart_at is None and LOG_PROFILE[0] <= b < LOG_PROFILE[1]:
                continue
            step(b)
            if b == LOG_BATCHES - 1:
                rows.extend(pipe.flush())
                torch.cuda.synchronize()
                timing["columnar_wall_s"] = time.perf_counter() - t0
        rows.extend(pipe.flush())
        rows.extend(ex.drain_closed())
        torch.cuda.synchronize()
        timing["wall_s"] = time.perf_counter() - t0
        assert rd.read(1) == [], "the log holds more than was appended"
    finally:
        pipe.close()
        store.close()
    return dict(rows=rows, launches=launch_counts(), **sec, **timing)


def log_reference(ls: LogStream) -> dict:
    """numpy: per window start, per key: count, sum of LOG10(|t| + 1) and
    of EXP(t / 50) (float64 of the float32 arguments), MAX(rint t) and
    MIN(ceil t) over the records with SQRT(|t|) > 4 (float32 sqrt, which
    is correctly rounded in numpy as on the card)."""
    def part(kids, temps):
        keep = np.sqrt(np.abs(temps)) > np.float32(4.0)
        k, t = kids[keep], temps[keep]
        mx = np.full(N_KEYS, -np.inf)
        mn = np.full(N_KEYS, np.inf)
        np.maximum.at(mx, k, np.rint(t).astype(np.float64))
        np.minimum.at(mn, k, np.ceil(t).astype(np.float64))
        lg = np.log10((np.abs(t) + np.float32(1)).astype(np.float64))
        ex = np.exp((t / np.float32(50)).astype(np.float64))
        return dict(count=np.bincount(k, minlength=N_KEYS),
                    log=np.bincount(k, lg, minlength=N_KEYS),
                    exp=np.bincount(k, ex, minlength=N_KEYS), max=mx, min=mn)

    per = [part(k, t) for k, t in zip(ls.src.kids, ls.src.temps)]
    size = 10_000
    edge = BASE_TS + size
    wins: dict[int, list] = {BASE_TS: [], edge: []}
    for b in range(LOG_BATCHES):
        _, ts, _ = ls.src.get(b)
        wins[BASE_TS if ts[-1] < edge else edge].append(per[b % N_UNIQUE])
    for kids, ts, temps in ls.json:
        sel = ts < edge + size
        wins[edge].append(part(kids[sel], temps[sel]))

    def fold(parts):
        return dict(count=sum(p["count"] for p in parts),
                    log=sum(p["log"] for p in parts),
                    exp=sum(p["exp"] for p in parts),
                    max=np.maximum.reduce([p["max"] for p in parts]),
                    min=np.minimum.reduce([p["min"] for p in parts]))

    return {w: fold(parts) for w, parts in wins.items()}


def log_cells(rows) -> dict:
    from hstream_tpu_torch.common.columnar import ColumnarEmit

    out = {}
    for r in rows if not isinstance(rows, ColumnarEmit) else list(rows):
        assert r["winEnd"] == r["winStart"] + 10_000, r
        out[(int(r["device"][1:]), r["winStart"])] = tuple(
            float(r[a]) for a in LOG_AGGS)
    return out


def check_log_rows(cells: dict, ref: dict) -> int:
    """Closed rows against numpy: COUNT, MAX(ROUND), MIN(CEIL) exact; SUM
    within the order bound (n 2^-24 sum|term|, terms positive) plus
    CUDA_ULP of LOG10 per term and the final rounding; AVG likewise over
    its sum, plus its division."""
    n_cells = 0
    for w, r in ref.items():
        for k in np.nonzero(r["count"])[0]:
            got = cells.pop((int(k), w))
            n = int(r["count"][k])
            assert got[0] == n and got[3] == r["max"][k] \
                and got[4] == r["min"][k], (k, w, got, n)
            lim = (n + 2 * CUDA_ULP["LOG10"] + 1) * U * r["log"][k]
            assert abs(got[1] - r["log"][k]) <= lim, (k, w, got[1], lim)
            want = r["exp"][k] / n
            lim = (n + 2 * CUDA_ULP["EXP"] + 2) * U * want
            assert abs(got[2] - want) <= lim, (k, w, got[2], want, lim)
            n_cells += 1
    assert not cells, f"rows without a numpy cell: {list(cells)[:4]}"
    return n_cells


def log_path(dev) -> dict:
    """Phase 11: from the durable log, through the restart, into rows."""
    import tempfile

    from hstream_tpu_torch.common import jsondec

    assert jsondec.load() is not None, "the native JSON decoder is missing"
    ls = LogStream(seed=LOG_SEED)
    ref = log_reference(ls)
    with tempfile.TemporaryDirectory(prefix="hstream_log_") as tmp:
        uri = f"file://{tmp}/store"
        app = log_append(ls, uri)
        plain = log_run(dev, uri, app["sid"], f"{tmp}/ckp.json", "plain",
                        None)
        run = log_run(dev, uri, app["sid"], f"{tmp}/ckp.json", "stats",
                      LOG_RESTART_AT)
    cells, base = log_cells(run["rows"]), log_cells(plain["rows"])
    assert sorted(cells) == sorted(base), "closed rows differ"
    for key, got in cells.items():
        want = base[key]
        assert got[0] == want[0] and got[3:] == want[3:], (key, got, want)
        n = got[0]
        for i in (1, 2):  # two summation orders
            assert abs(got[i] - want[i]) <= 2 * (n + 1) * U * abs(want[i]), \
                (key, got, want)
    n_cells = check_log_rows(dict(cells), ref)
    assert {w for _, w in cells} == set(ref) and n_cells == len(cells)
    counts = run["launches"]
    steps = LOG_BATCHES + LOG_JSON_BATCHES
    assert counts["wire_decode"] == counts["scatter_aggregate"] == \
        counts["expression"] == counts["expression_unaries"] == steps, counts
    assert counts["fused_close"] == 2, counts
    events = LOG_BATCHES * BATCH + LOG_JSON_BATCHES * LOG_JSON_ROWS
    return dict(config="from the durable log (11)", rows=len(cells),
                windows=len(ref), launches=counts,
                store_bytes=app["store_bytes"],
                produce_s=app["produce_s"], append_s=app["append_s"],
                json_build_s=ls.json_build_s,
                json_append_s=app["json_append_s"],
                read_s=run["read_s"], decode_s=run["decode_s"],
                json_decode_s=run["json_decode_s"],
                restart_s=run["restart_s"], blob_bytes=run["blob_bytes"],
                wall_s=run["wall_s"],
                events_per_sec=events / (run["wall_s"] - run["restart_s"]),
                columnar_events_per_sec=LOG_BATCHES * BATCH
                / (run["columnar_wall_s"] - run["restart_s"]),
                uninterrupted_wall_s=plain["wall_s"],
                device_busy_share=plain["device_busy_share"],
                profile_batches=plain["profile_batches"],
                uninterrupted_launches=plain["launches"])


# ---- phase 12: kernel-family device time, compiles and fault points ---------

TRACE_BATCHES = 16          # config 1, each batch one 10 s window
TRACE_MS_PER_BATCH = 10_000
TRACE_RATE = 4              # DEVICE_TIME samples every 4th dispatch
TRACE_SESS_BATCHES = 8
TRACE_SESS_STRETCH = 4
TRACE_DISARMED_BATCHES = 4


def _planes_equal(planes: dict, clone: dict) -> bool:
    """Byte for byte (a view as int8: NaN payloads and -0.0 count)."""
    return set(planes) == set(clone) and all(
        torch.equal(v.contiguous().view(torch.int8),
                    clone[k].contiguous().view(torch.int8))
        for k, v in planes.items())


def _fired(site: str, call, *args) -> str:
    """Arm `site` to fail its next hit, make the call, require the
    injected fault to come out of it; returns its message."""
    from hstream_tpu_torch.common.faultinject import FAULTS, InjectedFault

    FAULTS.arm(site, "fail:1")
    try:
        call(*args)
    except InjectedFault as e:
        assert e.site == site, (e.site, site)
        return str(e)
    finally:
        FAULTS.disarm()
    raise AssertionError(f"{site}: the armed fault did not fire")


def _ring(family: str) -> dict:
    from hstream_tpu_torch.stats.devicecost import DEVICE_TIME

    xs = DEVICE_TIME.samples(family)
    assert xs, f"no {family} sample"
    srt = sorted(xs)
    # a ring holds 2-4 samples here: its p99 is its max, and reads so
    return dict(samples=len(xs), p50=srt[len(srt) // 2], max=srt[-1],
                min=srt[0], ms=xs)


def _trace_batch(src, b: int):
    """Config 1's batch b re-timed to fill window b: records of the
    unique batch b mod 8 spread over [b * 10 s, (b + 1) * 10 s)."""
    kids, _ts, temps = src.get(b)
    ts = BASE_TS + b * TRACE_MS_PER_BATCH + \
        src.ts_template * (TRACE_MS_PER_BATCH // STREAM_MS_PER_BATCH)
    return kids, ts, temps


def _trace_executor(dev):
    from hstream_tpu_torch.engine import (AggregateNode, ColumnType,
                                          QueryExecutor, Schema, SourceNode)
    from hstream_tpu_torch.engine.expr import Col

    spec = make_spec(1)
    schema = Schema.of(device=ColumnType.STRING, temp=ColumnType.FLOAT)
    node = AggregateNode(child=SourceNode("sensors", schema),
                         group_keys=[Col("device")], window=spec.window,
                         aggs=list(spec.aggs))
    ex = QueryExecutor(node, schema, emit_changes=False, initial_keys=1024,
                       batch_capacity=BATCH)
    assert ex.device == dev, ex.device
    for k in range(N_KEYS):
        ex.key_id_for((f"d{k}",))
    return spec, ex


def traced_window(dev, results) -> dict:
    """Config 1 through QueryExecutor.process_columnar for 16 batches of
    2^20 records, one 10 s window each (a close a batch, deferred),
    DEVICE_TIME armed at rate 4; a RetraceGuard over the batches after
    the first four; device.dispatch fired at batch 6 (the batch is sent
    again), device.activate at batch 9's close and again at the close
    cycle alone, device.fetch at the final drain. Each fault must raise
    and leave the planes byte-equal to a clone; the rows equal numpy."""
    from hstream_tpu_torch.common.tracing import RetraceGuard
    from hstream_tpu_torch.stats.devicecost import DEVICE_TIME

    spec, ex = _trace_executor(dev)
    ex.defer_close_decode = True
    src = Batches(seed=1)
    per_key = src.per_key()
    faults = {}
    DEVICE_TIME.disarm()
    DEVICE_TIME.reset()
    DEVICE_TIME.arm(TRACE_RATE)
    zero_counts()
    rows: list = []
    guard = RetraceGuard(name="phase12")
    try:
        for b in range(TRACE_BATCHES):
            if b == 4:
                guard.__enter__()
            kids, ts, temps = _trace_batch(src, b)
            cols = {"temp": temps}
            if b == 6:
                clone = copy_state(ex.state)
                wm, opened = ex.watermark_abs, sorted(ex._open)
                faults["device.dispatch"] = _fired(
                    "device.dispatch", ex.process_columnar, kids, ts, cols)
                torch.cuda.synchronize()
                assert _planes_equal(ex.state, clone), "device.dispatch"
                assert (ex.watermark_abs, sorted(ex._open)) == (wm, opened)
            if b == 9:
                faults["device.activate (batch)"] = _fired(
                    "device.activate", ex.process_columnar, kids, ts, cols)
                clone = copy_state(ex.state)
                opened = sorted(ex._open)
                faults["device.activate"] = _fired(
                    "device.activate", ex.close_due_windows)
                torch.cuda.synchronize()
                assert _planes_equal(ex.state, clone), "device.activate"
                assert sorted(ex._open) == opened
                rows.extend(ex.close_due_windows())
                continue
            rows.extend(ex.process_columnar(kids, ts, cols))
    finally:
        guard.__exit__(None, None, None)
        DEVICE_TIME.disarm()
    clone = copy_state(ex.state)
    pending = len(ex._pending_closes)
    faults["device.fetch"] = _fired("device.fetch", ex.drain_closed)
    torch.cuda.synchronize()
    assert _planes_equal(ex.state, clone), "device.fetch"
    assert len(ex._pending_closes) == pending > 0
    rows.extend(ex.drain_closed())
    size = spec.window.size_ms
    n_windows = check_rows(
        1, spec, rows, per_key, dev,
        ref_of=lambda start: per_key[((start - BASE_TS) // size) % N_UNIQUE])
    counts = launch_counts()
    st = dict(ex.close_stats)
    assert counts["wire_decode"] == counts["scatter_aggregate"] == \
        TRACE_BATCHES, counts
    assert counts["fused_close"] == st["close_dispatches"] == \
        st["close_cycles"] == TRACE_BATCHES - 1, (counts, st)
    assert st["close_fetches"] == 1, st       # one drain, one shape
    assert guard.count == 0, f"{guard.count} compiles in steady state"
    state = DEVICE_TIME.state()
    assert state["counts"] == {"step": TRACE_BATCHES,
                               "close": TRACE_BATCHES - 1}, state
    step, close = _ring("step"), _ring("close")
    assert step["samples"] == TRACE_BATCHES // TRACE_RATE
    assert close["samples"] == (TRACE_BATCHES - 1) // TRACE_RATE
    kernels = results["wire_decode"]["ms"] + \
        results["scatter_aggregate"]["ms"]
    assert step["min"] >= kernels, (step, kernels)
    # disarmed: a fresh executor's batches leave the sampler empty
    DEVICE_TIME.reset()
    _spec, ex2 = _trace_executor(dev)
    for b in range(TRACE_DISARMED_BATCHES):
        kids, ts, temps = _trace_batch(src, b)
        ex2.process_columnar(kids, ts, {"temp": temps})
    torch.cuda.synchronize()
    disarmed = DEVICE_TIME.state()
    assert disarmed == {"counts": {}, "samples": {}}, disarmed
    return dict(step=step, close=close, profiled_step_kernels_ms=kernels,
                profiled_close_ms=results["fused_close"]["ms"],
                windows_checked=n_windows, rows=len(rows), faults=faults,
                steady_compiles=guard.count, disarmed_state=disarmed,
                close_stats=st, launches=counts)


def traced_session(dev, results) -> dict:
    """Config 4's stream for 8 batches (2^20 records each, 4 s of stream
    a batch, record mode) with DEVICE_TIME armed at rate 4; device.session.dispatch fired at batch
    4's step (the arena and its mirror byte-equal to a clone, the batch
    sent again); the sessions against numpy."""
    from hstream_tpu_torch.common.tracing import RetraceGuard
    from hstream_tpu_torch.engine import SessionExecutor
    from hstream_tpu_torch.engine.sketches import QuantileConfig
    from hstream_tpu_torch.stats.devicecost import DEVICE_TIME

    qcfg = QuantileConfig()
    src = SessionStream(seed=12, n_batches=TRACE_SESS_BATCHES)
    # 4 s of stream a batch (the path's 1 s, stretched): sessions close
    # within the 8 batches
    src.ts = [BASE_TS + (t - BASE_TS) * TRACE_SESS_STRETCH for t in src.ts]
    ref = session_reference(src, TRACE_SESS_BATCHES, qcfg)
    node, schema = session_plan()
    ex = SessionExecutor(node, schema)
    ex.defer_close_decode = True
    ex.device_session_mode = "record"
    DEVICE_TIME.reset()
    DEVICE_TIME.arm(TRACE_RATE)
    zero_counts()
    rows, fault = [], None
    guard = RetraceGuard(name="phase12")
    try:
        for b in range(TRACE_SESS_BATCHES):
            ts, cols = src.get(b)
            if b == 2:
                guard.__enter__()
            if b == 4:
                dev_ = ex._dev
                clone = copy_state(dev_["arena"])
                mirror = [dev_[k].copy() for k in
                          ("mir_code", "mir_t0", "mir_t1", "mir_live")]
                fault = _fired("device.session.dispatch",
                               ex.process_columnar, ts, cols)
                torch.cuda.synchronize()
                assert _planes_equal(dev_["arena"], clone), \
                    "device.session.dispatch"
                assert all(np.array_equal(a, dev_[k]) for a, k in zip(
                    mirror, ("mir_code", "mir_t0", "mir_t1", "mir_live")))
            rows.extend(ex.process_columnar(ts, cols))
        rows.extend(ex.drain_closed())
        torch.cuda.synchronize()
    finally:
        guard.__exit__(None, None, None)
        DEVICE_TIME.disarm()
    check = check_session_rows(rows, ref, qcfg)
    counts = launch_counts()
    st = dict(ex.session_stats)
    assert counts["session_step"] == st["step_dispatches"] == \
        TRACE_SESS_BATCHES, (counts, st)
    assert guard.count == 0, f"{guard.count} compiles in steady state"
    ring = _ring("session")
    assert ring["samples"] == TRACE_SESS_BATCHES // TRACE_RATE
    return dict(session=ring, profiled_step_ms=results["session_step"]["ms"],
                close=DEVICE_TIME.percentiles().get("close"), check=check,
                fault=fault, steady_compiles=guard.count, session_stats=st,
                launches=counts)


def traced_probe(dev, results) -> dict:
    """Phase 8b's query and shape (2^16-record batches over 32,000 keys)
    for 4 + 8 batches with DEVICE_TIME armed at rate 4: every probe
    dispatch after the activation is a "probe" one; the final changes
    against numpy."""
    from hstream_tpu_torch.common.tracing import RetraceGuard
    from hstream_tpu_torch.stats.devicecost import DEVICE_TIME

    src = JoinStream(8, FETCH_BATCH, FETCH_KEYS, with_x=True)
    ex = _join_executor(join_fetch_plan(), FETCH_BATCH, dev)
    ex.match_drain_depth = 4
    log_ = ChangeLog(src.keys)
    n_batches = FETCH_WARM + FETCH_TIMED
    DEVICE_TIME.reset()
    DEVICE_TIME.arm(TRACE_RATE)
    zero_counts()
    guard = RetraceGuard(name="phase12")
    try:
        for b in range(n_batches):
            if b == FETCH_WARM:
                guard.__enter__()
            ts, cols, side = src.get(b)
            log_.add(ex.process_columnar(ts, cols, stream=side))
            if b == 1:
                ex.coalesce_rows = 1 << 15
        log_.add(ex.flush_changes())
        torch.cuda.synchronize()
    finally:
        guard.__exit__(None, None, None)
        DEVICE_TIME.disarm()
    js = dict(ex.join_stats)
    counts = launch_counts()
    check = check_join_changes(
        log_, join_reference(src, n_batches, 1000, 10_000), with_sum=True)
    assert js["probe_dispatches"] == counts["join_probe_insert"], \
        (js, counts)
    assert guard.count == 0, f"{guard.count} compiles in steady state"
    assert DEVICE_TIME.state()["counts"]["probe"] == js["probe_dispatches"]
    ring = _ring("probe")
    assert ring["samples"] == js["probe_dispatches"] // TRACE_RATE
    return dict(probe=ring,
                profiled_probe_ms=results["join_probe_insert"]["ms"],
                check=check, join_stats=js, steady_compiles=guard.count,
                launches=counts)


def sampler_floor(dev) -> dict:
    """What a sampled dispatch reads around an empty kernel: 8 samples
    back to back and 8 each after 20 ms with the card idle (as the
    paths' dispatches come, after the host's encode), through the same
    kernel_family / DEVICE_TIME path as the families."""
    from hstream_tpu_torch.common.tracing import kernel_family
    from hstream_tpu_torch.engine.kernels import binding as kb
    from hstream_tpu_torch.stats.devicecost import DEVICE_TIME

    stream = torch.cuda.current_stream(dev).cuda_stream
    vals = (torch.zeros(1, device=dev),)
    out = {}
    for name, idle_s in (("back to back", 0.0), ("after 20 ms idle", 0.02)):
        DEVICE_TIME.reset()
        DEVICE_TIME.arm(1)
        try:
            for _ in range(8):
                torch.cuda.synchronize()
                time.sleep(idle_s)
                with kernel_family("floor", ready=lambda: vals):
                    kb.check(kb.lib().hs_empty(stream), "empty")
        finally:
            DEVICE_TIME.disarm()
        xs = sorted(DEVICE_TIME.samples("floor"))
        out[name] = dict(p50=xs[len(xs) // 2], max=xs[-1], ms=xs)
    DEVICE_TIME.reset()
    return out


def step_split(dev) -> dict:
    """Where a sampled step's time goes, on config 1's phase-12 batches:
    DEVICE_TIME at rate 2 and a dispatch observer, so every other step is
    sampled (the device's time between the scope's two events) and the
    others give the host's time inside the scope, with no wait in it.
    The batches come in pairs of two kinds: "idle", as phase 12 (the card
    idle through the host's encode), and "busy", the card kept busy
    through the encode by a spin kernel, so that the step's kernels are
    queued before its start event runs and a sample reads them alone."""
    from hstream_tpu_torch.stats.devicecost import DEVICE_TIME

    _spec, ex = _trace_executor(dev)
    src = Batches(seed=1)
    host: list = []
    ex.dispatch_observer = (lambda fam, sec: host.append(sec * 1e3)
                            if fam == "step" else None)
    kinds = []
    DEVICE_TIME.reset()
    DEVICE_TIME.arm(2)
    try:
        for b in range(4 + 16):      # 4 warm-up batches, then 8 pairs
            kind = "idle" if b < 4 or (b // 2) % 2 == 0 else "busy"
            if kind == "busy":
                torch.cuda._sleep(int(2e8))     # ~0.1 s of spin
            kids, ts, temps = _trace_batch(src, b)
            ex.process_columnar(kids, ts, {"temp": temps})
            torch.cuda.synchronize()
            kinds.append(kind)
    finally:
        DEVICE_TIME.disarm()
    sampled = DEVICE_TIME.samples("step")   # the 2nd, 4th, ... steps
    DEVICE_TIME.reset()
    assert len(host) == len(kinds) and len(sampled) == len(kinds) // 2
    out = {}
    for kind in ("idle", "busy"):
        dev_ms = [sampled[i // 2] for i in range(4, len(kinds))
                  if i % 2 == 1 and kinds[i] == kind]
        host_ms = [host[i] for i in range(4, len(kinds))
                   if i % 2 == 0 and kinds[i] == kind]
        out[kind] = dict(device_ms=dev_ms, host_ms=host_ms,
                         device_p50=float(np.median(dev_ms)),
                         host_p50=float(np.median(host_ms)))
    return out


def traced_path(dev, results) -> dict:
    """Phase 12: the kernel families' device time (DEVICE_TIME), the
    steady state's compiles (RetraceGuard) and four fault points, on the
    window, session and join executors; and the sampler's own floor."""
    floor = sampler_floor(dev)
    split = step_split(dev)
    w = traced_window(dev, results)
    s = traced_session(dev, results)
    j = traced_probe(dev, results)
    launches = {k: w["launches"][k] + s["launches"][k] + j["launches"][k]
                for k in w["launches"]}
    return dict(config="12", window=w, session=s, probe=j,
                launches=launches, sampler_floor=floor, step_split=split)


# ---- phase 13: the single-node server (bench.py:768's served path) ----------

SRV_BLOCK = 1 << 18          # bench.py:768's n
SRV_MS = 500                 # stream ms a block: 20 blocks a 10 s window
SRV_WIN_BLOCKS = 10_000 // SRV_MS
SRV_BLOCKS = 64              # a run: past three window ends
SRV_RUNS = 3
SRV_PAUSE = 30               # the quiet pull: window 1 ten blocks in
SRV_PROFILE = 12             # blocks of the profiled window after the runs
SRV_ACKS = 12                # blocks a call each after it: ack latency
SRV_RESTART_AT = 30          # the restore flow: blocks before the restart
SRV_RESTART_BLOCKS = 48      # ... and in all
SRV_DRAIN_S = 300.0
SRV_VIEW = ("CREATE VIEW headline AS SELECT device, COUNT(*) AS cnt, "
            "SUM(temp) AS total, APPROX_COUNT_DISTINCT(temp) AS uniq "
            "FROM sensors GROUP BY device, TUMBLING (INTERVAL 10 SECOND) "
            "GRACE BY INTERVAL 0 SECOND;")
SRV_PUSH = ("SELECT device, COUNT(*) AS c, SUM(temp) AS s FROM sensors "
            "GROUP BY device, TUMBLING (INTERVAL 10 SECOND) "
            "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
SRV_PUSH_ID = "headline_changes"
SRV_DEVS = np.array([f"d{k}" for k in range(N_KEYS)])


class ServerStream:
    """Config 1's stream as bench.py:768 sends it: framed blocks of 2^18
    records (client.producer.encode_batch), device strings d0..d999 and
    one-decimal temps, N_UNIQUE pre-made (keys, temps) pairs cycled,
    SRV_MS of stream a block in order, so windows start on block
    boundaries."""

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        self.kids = [rng.integers(0, N_KEYS, SRV_BLOCK).astype(np.int32)
                     for _ in range(N_UNIQUE)]
        self.temps = [(np.rint(rng.normal(20.0, 5.0, SRV_BLOCK) * 10)
                       .astype(np.float32) * np.float32(0.1))
                      for _ in range(N_UNIQUE)]
        self.ts_template = (np.arange(SRV_BLOCK, dtype=np.int64)
                            * SRV_MS) // SRV_BLOCK
        self.per = []
        for k, t in zip(self.kids, self.temps):
            t64 = t.astype(np.float64)
            regs = np.zeros(N_KEYS * 1024, np.int8)
            reg, rank = np_hll_indices(t)
            np.maximum.at(regs, k.astype(np.int64) * 1024 + reg,
                          rank.astype(np.int8))
            self.per.append(dict(
                count=np.bincount(k, minlength=N_KEYS),
                sum=np.bincount(k, weights=t64, minlength=N_KEYS),
                abs=np.bincount(k, weights=np.abs(t64), minlength=N_KEYS),
                regs=regs.reshape(N_KEYS, 1024)))

    def ts(self, b: int) -> np.ndarray:
        return BASE_TS + b * SRV_MS + self.ts_template

    def last_ts(self, b: int) -> int:
        return int(BASE_TS + b * SRV_MS + self.ts_template[-1])

    def frame(self, b: int) -> bytes:
        from hstream_tpu_torch.client.producer import encode_batch

        j = b % N_UNIQUE
        return encode_batch(self.ts(b), {"device": SRV_DEVS[self.kids[j]],
                                         "temp": self.temps[j]})

    def window(self, w: int, blocks: int) -> dict:
        """Aggregates of window w over its first `blocks` blocks."""
        lo = w * SRV_WIN_BLOCKS
        parts = [self.per[b % N_UNIQUE] for b in range(lo, lo + blocks)]
        return {k: (sum(p[k] for p in parts) if k != "regs" else
                    np.maximum.reduce([p[k] for p in parts]))
                for k in ("count", "sum", "abs", "regs")}


def _window_of(start: int) -> int:
    w, rem = divmod(start - BASE_TS, 10_000)
    assert rem == 0 and w >= 0, start
    return w


def check_server_window(rows, ref, dev, what: str, cnt="cnt", total="total",
                        uniq="uniq") -> None:
    """One window's rows (every key with records once) against numpy:
    counts and HLL estimates exact, SUM within the summation-order
    bound."""
    from hstream_tpu_torch.engine.sketches import hll_estimate

    keys = np.array([int(r["device"][1:]) for r in rows])
    assert sorted(keys.tolist()) == np.nonzero(ref["count"])[0].tolist(), \
        f"{what}: {len(rows)} rows"
    n = ref["count"][keys]
    got = np.array([r[cnt] for r in rows])
    assert (got == n).all(), f"{what}: counts differ"
    lim = 2 * n * U * ref["abs"][keys]
    got_sum = np.array([r[total] for r in rows], np.float64)
    assert (np.abs(got_sum - ref["sum"][keys]) <= lim).all(), \
        f"{what}: SUM beyond the bound"
    if uniq is not None:
        regs = torch.from_numpy(ref["regs"][keys][:, None, :]).to(dev)
        est = hll_estimate(regs, make_spec(1).hll)[:, 0].cpu().numpy()
        got_u = np.array([r[uniq] for r in rows])
        assert (got_u == np.rint(est)).all(), f"{what}: HLL estimate differs"


def check_pull(rows, src, dev, blocks: int, what: str,
               prefix: bool = False) -> dict:
    """A pull query's rows: every window through block `blocks` (closed
    or live) against numpy. With `prefix`, the pull was taken while the
    stream was being ingested: each window must equal numpy over a
    whole-block prefix of its records, which its total count names."""
    by_win: dict[int, list] = {}
    for r in rows:
        by_win.setdefault(_window_of(r["winStart"]), []).append(r)
    seen = {}
    for w, rs in sorted(by_win.items()):
        total = sum(r["cnt"] for r in rs)
        have, rem = divmod(total, SRV_BLOCK)
        assert rem == 0, f"{what}: window {w} holds {total} records"
        full = min(SRV_WIN_BLOCKS, blocks - w * SRV_WIN_BLOCKS)
        assert have == full or (prefix and 0 < have <= full), \
            f"{what}: window {w} has {have} blocks, the stream {full}"
        check_server_window(rs, src.window(w, have), dev,
                            f"{what} window {w}")
        seen[w] = have
    if not prefix:
        want = -(-blocks // SRV_WIN_BLOCKS)
        assert sorted(seen) == list(range(want)), (what, sorted(seen))
    return seen


def _srv_task(ctx, qid: str):
    """The query's task once attached to its source."""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        task = ctx.running_queries.get(qid)
        if task is not None and task.attached.wait(0.05):
            return task
    raise AssertionError(f"server: query {qid} never attached")


def _srv_drained(tasks, ts_target: int) -> None:
    """Every task's executor stepped up to ts_target (bench.py:768's
    drain_to: the watermark), then the card finished."""
    deadline = time.monotonic() + SRV_DRAIN_S
    pause = threading.Event()
    while time.monotonic() < deadline:
        if all(t.executor is not None
               and t.executor.watermark_abs >= ts_target for t in tasks):
            torch.cuda.synchronize()
            return
        assert all(t.error is None for t in tasks), \
            [t.error for t in tasks]
        pause.wait(0.002)
    raise AssertionError(f"server: not drained to {ts_target} in "
                         f"{SRV_DRAIN_S} s")


def _srv_pull(stub, pb, records) -> list:
    resp = stub.ExecuteQuery(pb.CommandQuery(
        stmt_text="SELECT * FROM headline;"))
    return [records.struct_to_dict(s) for s in resp.result_set]


def _push_finals(ctx, stream: str = SRV_PUSH_ID, temp: bool = True) -> dict:
    """(device, winStart) -> the last change a push query sank into its
    stream (the temporary stream of phase 13's push query by default),
    read back from the store (columnar records)."""
    from hstream_tpu_torch.common import columnar, records
    from hstream_tpu_torch.store.api import DataBatch
    from hstream_tpu_torch.store.streams import StreamType

    logid = ctx.streams.get_logid(
        stream, StreamType.TEMP if temp else StreamType.STREAM)
    reader = ctx.store.new_reader()
    reader.start_reading(logid)
    reader.set_timeout(0)
    out: dict = {}
    while True:
        got = reader.read(1024)
        if not got:
            break
        for b in got:
            if not isinstance(b, DataBatch):
                continue
            for p in b.payloads:
                body = records.peek_columnar_payload(p)
                if body is None:
                    r = records.record_to_dict(records.parse_record(p))
                    out[(r["device"], r["winStart"])] = r
                    continue
                for r in columnar.payload_rows(bytes(body)):
                    out[(r["device"], r["winStart"])] = r
    reader.stop_reading(logid)
    return out


def check_push(ctx, src, dev, blocks: int) -> int:
    """Every (device, window)'s last change against numpy, once the
    changes of the last block reached the sink stream."""
    last_w = (blocks - 1) // SRV_WIN_BLOCKS
    last_n = blocks - last_w * SRV_WIN_BLOCKS
    want = last_n * SRV_BLOCK
    deadline = time.monotonic() + SRV_DRAIN_S
    pause = threading.Event()
    while True:
        finals = _push_finals(ctx)
        got = sum(r["c"] for (d, ws), r in finals.items()
                  if _window_of(ws) == last_w)
        if got == want:
            break
        assert time.monotonic() < deadline, \
            f"push query: {got} of {want} records in its last window"
        pause.wait(0.05)
    by_win: dict[int, list] = {}
    for (_d, ws), r in finals.items():
        by_win.setdefault(_window_of(ws), []).append(r)
    assert sorted(by_win) == list(range(last_w + 1)), sorted(by_win)
    for w, rs in by_win.items():
        have = SRV_WIN_BLOCKS if w < last_w else last_n
        check_server_window(rs, src.window(w, have), dev,
                            f"push query window {w}", cnt="c", total="s",
                            uniq=None)
    return len(finals)


def _metrics_p50(text: str, metric: str) -> dict:
    """{label: p50} of a histogram in a Prometheus exposition, the
    bucket-interpolated estimate StatsHolder's Histogram gives."""
    import re

    pat = re.compile(r'^hstream_%s_bucket\{(\w+)="([^"]*)",le="([^"]+)"\} '
                     r'(\S+)$' % metric)
    buckets: dict[str, list] = {}
    for ln in text.splitlines():
        m = pat.match(ln)
        if m:
            le = float("inf") if m.group(3) == "+Inf" else float(m.group(3))
            buckets.setdefault(m.group(2), []).append((le, float(m.group(4))))
    out = {}
    for label, bs in buckets.items():
        bs.sort()
        total = bs[-1][1]
        if total <= 0:
            continue
        rank, prev_c, prev_le = total / 2, 0.0, 0.0
        for le, c in bs:
            if c >= rank:
                if le == float("inf"):
                    out[label] = prev_le
                else:
                    frac = (rank - prev_c) / (c - prev_c) if c > prev_c \
                        else 1.0
                    out[label] = prev_le + (le - prev_le) * frac
                break
            prev_c, prev_le = c, le
    return out


def server_path(dev, results) -> dict:
    """Phase 13: the port's gRPC server on the card, driven over loopback
    through its stub: the headline view, a pull query of it in the quiet
    and during ingest (B3), bench.py:768's push query; runs of framed
    AppendColumnarStream blocks timed from the append to the drained
    watermark; the rows against numpy; then a restart over a file://
    store that restores the view's snapshot on the card."""
    import urllib.request

    import grpc

    from hstream_tpu_torch.client.producer import ColumnarProducer
    from hstream_tpu_torch.common import records
    from hstream_tpu_torch.proto import api_pb2 as pb
    from hstream_tpu_torch.proto.rpc import HStreamApiStub
    from hstream_tpu_torch.server.main import serve

    src = ServerStream(seed=13)
    n_blocks = SRV_RUNS * SRV_BLOCKS
    t0 = time.perf_counter()
    frames = [src.frame(b)
              for b in range(n_blocks + SRV_PROFILE + SRV_ACKS)]
    encode_s = time.perf_counter() - t0
    server, ctx = serve("127.0.0.1", 0, "mem://", device_time_sample=4,
                        metrics_port=0)
    opts = [("grpc.max_receive_message_length", 64 << 20),
            ("grpc.max_send_message_length", 64 << 20)]
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}", options=opts)
    stub = HStreamApiStub(ch)
    try:
        assert ctx.device == dev, ctx.device
        stub.CreateStream(pb.Stream(stream_name="sensors"))
        stub.ExecuteQuery(pb.CommandQuery(stmt_text=SRV_VIEW))
        stub.CreateQuery(pb.CreateQueryRequest(query_text=SRV_PUSH,
                                               id=SRV_PUSH_ID))
        tasks = [_srv_task(ctx, "view-headline"), _srv_task(ctx, SRV_PUSH_ID)]
        producer = ColumnarProducer(ch, "sensors")
        zero_counts()
        runs, pulls = [], []
        # run 1: SRV_PAUSE blocks, a pull in the quiet, then the rest of
        # the run with pulls taken while it is ingested
        t0 = time.perf_counter()
        resp = producer.append_stream_frames(iter(frames[:SRV_PAUSE]))
        assert resp.rows == SRV_PAUSE * SRV_BLOCK, resp.rows
        _srv_drained(tasks, src.last_ts(SRV_PAUSE - 1))
        first_s = time.perf_counter() - t0
        assert all(t.executor.device == dev for t in tasks), \
            [t.executor.device for t in tasks]
        launches0 = launch_counts()
        quiet = check_pull(_srv_pull(stub, pb, records), src, dev, SRV_PAUSE,
                           "the quiet pull")
        assert launch_counts()["extract_close"] > \
            launches0["extract_close"], "the pull launched no B3"
        stop = threading.Event()

        def puller():
            while not stop.is_set():
                pulls.append(_srv_pull(stub, pb, records))

        th = threading.Thread(target=puller, daemon=True)
        t0 = time.perf_counter()
        th.start()
        resp = producer.append_stream_frames(iter(frames[SRV_PAUSE:
                                                         SRV_BLOCKS]))
        _srv_drained(tasks, src.last_ts(SRV_BLOCKS - 1))
        wall = first_s + time.perf_counter() - t0
        stop.set()
        th.join(60)
        runs.append(SRV_BLOCKS * SRV_BLOCK / wall)
        for r in range(1, SRV_RUNS):
            lo = r * SRV_BLOCKS
            t0 = time.perf_counter()
            resp = producer.append_stream_frames(iter(
                frames[lo:lo + SRV_BLOCKS]))
            _srv_drained(tasks, src.last_ts(lo + SRV_BLOCKS - 1))
            runs.append(SRV_BLOCKS * SRV_BLOCK / (time.perf_counter() - t0))
            assert resp.rows == SRV_BLOCKS * SRV_BLOCK
        counts = launch_counts()
        # a profiled window of SRV_PROFILE more blocks: the card's busy
        # share while the server ingests
        def window():
            t0 = time.perf_counter()
            producer.append_stream_frames(iter(
                frames[n_blocks:n_blocks + SRV_PROFILE]))
            _srv_drained(tasks, src.last_ts(n_blocks + SRV_PROFILE - 1))
            return time.perf_counter() - t0

        prof_wall, devt = profiled(window)
        n_blocks += SRV_PROFILE
        busy = sum(devt.values()) / 1e6 / prof_wall
        # ack latency a block without replication (phase 16 has it with):
        # SRV_ACKS more blocks, each a call of its own
        acks = []
        for b in range(n_blocks, n_blocks + SRV_ACKS):
            t0 = time.perf_counter()
            producer.append_stream_frames(iter([frames[b]]))
            acks.append((time.perf_counter() - t0) * 1e3)
        n_blocks += SRV_ACKS
        _srv_drained(tasks, src.last_ts(n_blocks - 1))
        during = [check_pull(p, src, dev, n_blocks, "a pull during ingest",
                             prefix=True) for p in pulls]
        final = check_pull(_srv_pull(stub, pb, records), src, dev, n_blocks,
                           "the final pull")
        finals = check_push(ctx, src, dev, n_blocks)
        for t in tasks:
            assert t.engine_total("device_fallbacks") == 0, t.info.query_id
            assert t.executor.device == dev
        for name in ("wire_decode", "scatter_aggregate", "fused_close",
                     "extract_close", "reset_close", "touched_extract"):
            assert counts[name] > 0, (name, counts)
        assert counts["expression"] == counts["topk_fold"] == 0, counts
        assert all(counts[k] == 0 for k in counts
                   if k.startswith(("session", "join"))), counts
        url = f"http://127.0.0.1:{ctx.metrics_httpd.server_port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            text = r.read().decode()
        device_p50 = _metrics_p50(text, "kernel_device_ms")
        assert device_p50.get("step") and device_p50.get("close"), \
            device_p50
        view_rows = {(r["device"], r["winStart"]): r
                     for r in _srv_pull(stub, pb, records)}
    finally:
        ch.close()
        server.stop(grace=1)
        ctx.shutdown()
    restart = server_restore_path(dev, src, frames, view_rows)
    return dict(config="server", launches=counts,
                server_columnar_eps=float(np.median(runs)),
                server_columnar_eps_runs=runs, encode_s=encode_s,
                blocks=n_blocks, quiet_pull=quiet,
                pulls_during_ingest=len(pulls),
                pull_blocks_seen=[sorted(d.items()) for d in during[:4]],
                final_windows=len(final), push_finals=finals,
                kernel_device_ms_p50=device_p50,
                profile=dict(blocks=SRV_PROFILE, wall_s=prof_wall,
                             device_busy_share=busy),
                ack_ms=acks, ack_ms_p50=float(np.percentile(acks, 50)),
                ack_ms_p99=float(np.percentile(acks, 99)),
                restart=restart)


def server_restore_path(dev, src, frames, uninterrupted) -> dict:
    """A server over a file:// store under a temporary directory ingests
    SRV_RESTART_AT blocks into the headline view and stops with its task
    detached (a final snapshot); a second server over the same store
    restores the view on the card and ingests the rest. Its rows equal
    the uninterrupted run's (the first server's) and numpy."""
    import tempfile

    import grpc

    from hstream_tpu_torch.client.producer import ColumnarProducer
    from hstream_tpu_torch.common import records
    from hstream_tpu_torch.proto import api_pb2 as pb
    from hstream_tpu_torch.proto.rpc import HStreamApiStub
    from hstream_tpu_torch.server.main import serve

    with tempfile.TemporaryDirectory() as d:
        uri = "file://" + d
        out = {}
        for step, (lo, hi) in enumerate(((0, SRV_RESTART_AT),
                                         (SRV_RESTART_AT,
                                          SRV_RESTART_BLOCKS))):
            t0 = time.perf_counter()
            server, ctx = serve("127.0.0.1", 0, uri)
            ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
            stub = HStreamApiStub(ch)
            try:
                if step == 0:
                    stub.CreateStream(pb.Stream(stream_name="sensors"))
                    stub.ExecuteQuery(pb.CommandQuery(stmt_text=SRV_VIEW))
                task = _srv_task(ctx, "view-headline")
                if step == 1:
                    # resumed from the snapshot: built on the card
                    assert task.executor is not None and \
                        task.executor.device == dev, task.executor
                    out["boot_s"] = time.perf_counter() - t0
                producer = ColumnarProducer(ch, "sensors")
                producer.append_stream_frames(iter(frames[lo:hi]))
                _srv_drained([task], src.last_ts(hi - 1))
                rows = _srv_pull(stub, pb, records)
            finally:
                ch.close()
                server.stop(grace=1)
                ctx.shutdown()   # detaches the task: a final snapshot
        seen = check_pull(rows, src, dev, SRV_RESTART_BLOCKS,
                          "the restored view")
    same = 0
    for r in rows:
        w = _window_of(r["winStart"])
        if (w + 1) * SRV_WIN_BLOCKS > SRV_RESTART_BLOCKS:
            continue    # still open here, closed in the other run
        u = uninterrupted[(r["device"], r["winStart"])]
        assert (r["cnt"], r["uniq"]) == (u["cnt"], u["uniq"]), (r, u)
        ref = src.window(w, SRV_WIN_BLOCKS)
        k = int(r["device"][1:])
        lim = 4 * ref["count"][k] * U * ref["abs"][k]
        assert abs(r["total"] - u["total"]) <= lim, (r, u)
        same += 1
    assert same == N_KEYS * (SRV_RESTART_BLOCKS // SRV_WIN_BLOCKS), same
    out.update(windows=sorted(seen.items()), rows_equal_uninterrupted=same)
    return out


# ---- phase 14: the sharded window lattice, four shards on one card ----------

SH_MESH = (2, 2)             # (data, key): every shard on the one card
SH_BATCHES = 24              # 2^20-record batches, 2^19 a data shard
SH_MS = 1000                 # stream ms a batch: 10 s windows close
SH_PUSH_BATCHES = 16
SH_SRV_BLOCKS = 16           # phase 13's framed blocks of 2^18 records
SH_PATHS = ("sharded 1", "sharded 2", "sharded push", "sharded server",
            "sharded 1x24")


def sharded_specs() -> dict:
    """The local specs (Kl = 512 keys of K = 1024 over two key shards) of
    the merged kernels' checks: configs 1 and 2, the push query (with
    its touched flags), and every kind a mesh takes (TOPK has no
    elementwise merge) over 500 keys (off the close's key tiles)."""
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import TumblingWindow, lattice
    from hstream_tpu_torch.engine.expr import Col

    x = Col("temp")
    out = {f"config {c}": replace(make_spec(c), n_keys=512)
           for c in (1, 2)}
    out["push"] = push_spec(512)
    out["every kind"] = lattice.LatticeSpec(
        n_keys=500, window=TumblingWindow(10_000, grace_ms=30_000),
        aggs=(AggSpec(A.COUNT_ALL, "n"), AggSpec(A.SUM, "s", input=x),
              AggSpec(A.AVG, "a", input=x), AggSpec(A.MIN, "lo", input=x),
              AggSpec(A.MAX, "hi", input=x), AggSpec(A.COUNT, "c", input=x),
              AggSpec(A.APPROX_COUNT_DISTINCT, "u", input=x),
              AggSpec(A.APPROX_QUANTILE, "q", input=x, quantile=0.9)),
        track_touched=True)
    return out


def push_spec(n_keys: int = 1024):
    """bench.py:768's push query (SRV_PUSH): COUNT(*), SUM(temp) over
    TUMBLING 10 s, EMIT CHANGES."""
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import TumblingWindow, lattice
    from hstream_tpu_torch.engine.expr import Col

    return lattice.LatticeSpec(
        n_keys=n_keys, window=TumblingWindow(10_000, grace_ms=0),
        aggs=(AggSpec(A.COUNT_ALL, "c"),
              AggSpec(A.SUM, "s", input=Col("temp"))), track_touched=True)


def random_sharded_state(spec, dev, seed: int, mesh=SH_MESH):
    """The partials of a (data, key) mesh on the card, each
    random_lattice_state's."""
    from hstream_tpu_torch.parallel.lattice import ShardedState

    D, nk = mesh
    return ShardedState([random_lattice_state(spec, dev, seed + d * nk + k)
                         for k in range(nk)] for d in range(D))


# the merged changelog extract's meshes in phase 3 (every shard on the
# card), and those past 16 partials (a card's key shards or a key
# shard's data shards), each still one merged launch on the card
MERGED_MESHES = ((2, 2), (1, 4), (4, 1), (2, 3))
BIG_MESHES = ((2, 16), (1, 24), (17, 2), (32, 1))


def touched_specs() -> dict:
    """The merged changelog extract's lattices: the push query (scalars)
    and every kind a mesh takes (sketches), each with a key shard's
    cells within one block's scan (the one launch: 1,536 and 3,000) and
    past it (staged: 4,200)."""
    sp = sharded_specs()
    return {"push": sp["push"], "every kind": sp["every kind"],
            "push staged": replace(sp["push"], n_keys=1400),
            "every kind staged": replace(sp["every kind"], n_keys=700)}


def merged_touched_vs_plain(spec, state, mo: int, what: str) -> int:
    """The merged changelog extract against its plain version, each on
    its own copy of the partials: the buffers and every partial's planes
    (the flags cleared) exact. Returns the touched count."""
    from hstream_tpu_torch.parallel import lattice as pl

    a, b = copy_sharded(state), copy_sharded(state)
    got = pl.touched_merged(spec, a, mo)
    want = pl.touched_merged_ref(spec, b, mo)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"merged_touched {what}"
    assert sharded_equal(a, b), f"merged_touched {what}: partials"
    return int(want[:, 0, 0].max())


def small_sketches(spec):
    """`spec` with HLL p = 4 and 32 quantile bins: a staged lattice of up
    to 32 partials a few MB in all."""
    from hstream_tpu_torch.engine.sketches import HLLConfig, QuantileConfig

    return replace(spec, hll=HLLConfig(precision=4),
                   qcfg=QuantileConfig(n_bins=32))


def one_launch(fn, *args):
    """fn(*args) (a merged wrapper), asserted to launch its kernel once on
    the card (parallel.lattice.CARD_LAUNCHES); returns its result."""
    from hstream_tpu_torch.parallel import lattice as pl

    before = pl.CARD_LAUNCHES[fn.__name__]
    out = fn(*args)
    assert pl.CARD_LAUNCHES[fn.__name__] == before + 1, \
        (fn.__name__, pl.CARD_LAUNCHES[fn.__name__] - before)
    return out


def check_merged_meshes(dev) -> tuple[int, int, int]:
    """The merged changelog extract on MERGED_MESHES over touched_specs
    (one launch and staged), the last key shard touched nowhere, max_out
    at every cell, a fifth of them (below the touched count) and three
    short of them (not a multiple of four: scalar stores), exact against
    its plain version; then on BIG_MESHES (past 16 partials, one launch
    on the card, asserted) the extract in both forms (the push query and
    every kind at 16 keys a shard, and staged at touched_specs' sizes
    with small sketches),
    and the merged close (modes 0, 1 and 2, per slot) and the snapshot
    merge of the 16-key lattices. Returns the (touched, close, merge)
    cases."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.parallel import lattice as pl

    rng = np.random.default_rng(145)
    n_touched = n_close = n_merge = 0
    for mi, mesh in enumerate(MERGED_MESHES + BIG_MESHES):
        big = mesh in BIG_MESHES
        specs = ({k: small_sketches(v) if "staged" in k
                  else replace(v, n_keys=16)
                  for k, v in touched_specs().items()}
                 if big else touched_specs())
        for si, (name, spec) in enumerate(specs.items()):
            state = random_sharded_state(spec, dev, 800 + 40 * mi + si, mesh)
            assert len(pl.merged_groups(state)) == 1, mesh
            if mesh[1] > 1:
                for row in state:
                    row[-1]["touched"].zero_()
            cells = spec.n_keys * spec.n_slots
            for mo in (cells, cells // 5, cells - 3):
                before = pl.CARD_LAUNCHES["touched_merged"]
                most = merged_touched_vs_plain(spec, state, mo,
                                               f"{mesh} {name} max_out {mo}")
                assert pl.CARD_LAUNCHES["touched_merged"] == before + 1, \
                    mesh
                assert most > mo or mo != cells // 5, (mesh, name, most)
                n_touched += 1
            if not big or "staged" in name:
                continue
            W = spec.n_slots
            slots = lattice.pad_slots(rng.permutation(W)[:3]
                                      .astype(np.int32))
            for mode in (lattice.CLOSE_EXTRACT_RESET, lattice.CLOSE_EXTRACT,
                         lattice.CLOSE_RESET):
                a, b = copy_sharded(state), copy_sharded(state)
                got = one_launch(pl.close_merged, spec, a, slots, mode)
                want = pl.close_merged_ref(spec, b, slots, mode)
                torch.cuda.synchronize()
                if want is not None:
                    assert torch.equal(got, want), \
                        f"merged_close {mesh} {name} {mode}: rows"
                assert sharded_equal(a, b), f"merged_close {mesh} {name}"
                n_close += 1
            for mode in (lattice.CLOSE_EXTRACT, lattice.CLOSE_RESET):
                slot = int(rng.integers(0, W))
                a, b = copy_sharded(state), copy_sharded(state)
                got = one_launch(pl.close_slot_merged, spec, a, slot, mode)
                want = pl.close_slot_merged_ref(spec, b, slot, mode)
                torch.cuda.synchronize()
                if want is not None:
                    assert torch.equal(got, want), \
                        f"merged slot {mesh} {name}"
                assert sharded_equal(a, b), f"merged slot {mesh} {name}"
                n_close += 1
            got = one_launch(pl.merge_partials, spec, state)
            want = pl.merge_partials_ref(spec, state)
            torch.cuda.synchronize()
            assert list(got) == list(want), (mesh, name)
            for k in want:
                assert torch.equal(got[k], want[k]), \
                    f"shard_merge {mesh} {name}: {k}"
            n_merge += 1
            del state
    return n_touched, n_close, n_merge


def copy_sharded(state):
    from hstream_tpu_torch.parallel.lattice import ShardedState

    return ShardedState([copy_state(p) for p in row] for row in state)


def sharded_equal(a, b) -> bool:
    return all(torch.equal(pa[k], pb[k]) for ra, rb in zip(a, b)
               for pa, pb in zip(ra, rb) for k in pa)


def stacked_merge(state, kinds: dict, pick) -> None:
    """PyTorch's merge of every plane's partials (each through `pick`):
    torch.stack, then sum / amin / amax over the data axis, a plane and
    key shard a call (slot_start from key shard 0): the library yardstick
    of the merging kernels."""
    op = {"sum": "sum", "min": "amin", "max": "amax"}
    for name in state[0][0]:
        for k in ([0] if name == "slot_start" else range(state.n_key)):
            x = torch.stack([pick(p[name]) for p in state.key_shard(k)])
            getattr(x, op[kinds[name]])(0)


def check_sharded(dev, results):
    """B19a and B19d against their plain versions on the card, each exact:
    the block unpack (B19a-step) at odd block offsets and an odd pitch
    with every column type, NULL masks and three key shifts, and both
    data shards' 2^19-record blocks of config 1's 2^20 batch; the merged
    close (B19a-close) in modes 0, 1 and 2 (twice, the tile counters back
    at 0) and per slot, on configs 1 and 2, the push query and every kind
    a mesh takes, and past 16 partials on the card (BIG_MESHES, one
    launch); the merged changelog extract (B19a-touched), also with
    max_out below the touched count, on MERGED_MESHES and BIG_MESHES in
    both its launch forms (check_merged_meshes); the snapshot merge
    (B19d), on BIG_MESHES too. Then each timed at its main path's shape
    beside an empty kernel (the floor of a launch): config 1 and the push
    query over SH_MESH's four partials, and config 1's capture of
    make_mesh(2, 16) on the card."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.kernels import binding as kb
    from hstream_tpu_torch.parallel import lattice as pl

    rng = np.random.default_rng(141)
    # -- B19a-step: the block unpack
    layout = (("b", "bool"), ("i", "i32"), ("x", "f32"))
    cap = 12_297                                  # an odd pitch
    cols = {"b": rng.random(cap) < 0.5,
            "i": rng.integers(-99, 99, cap).astype(np.int32),
            "x": rng.normal(0, 9, cap).astype(np.float32)}
    nulls = [None, rng.random(cap) < 0.2, rng.random(cap) < 0.2]
    null_keys = (None, "__null_a1", "__null_a2")
    packed = torch.from_numpy(lattice.pack_batch_host(
        cap, cap - 5, rng.integers(0, 1024, cap).astype(np.int32),
        rng.integers(0, 1 << 20, cap).astype(np.int32),
        rng.random(cap) < 0.9, cols, nulls, layout)).to(dev)
    subs = [0, 333, -7]
    n_cases = 0
    for lo, count in ((0, 4099), (4099, 4099), (8198, 4099), (1, cap - 1),
                      (cap - 3, 3)):
        got = pl.unpack_block(packed, lo, count, layout, null_keys, subs)
        want = pl.unpack_block_ref(packed, lo, count, layout, null_keys,
                                   subs)
        torch.cuda.synchronize()
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w), f"sharded_step block {lo}"
        assert set(got[3]) == set(want[3])
        for k in want[3]:
            assert torch.equal(got[3][k], want[3][k]), \
                f"sharded_step block {lo}: {k}"
        n_cases += 1
    # timed at config 1's shape: data shard 1's 2^19-record block of a
    # 2^20 batch, its two key shards' columns
    nk1 = (None, "__null_a1", "__null_a2")
    lay1 = (("temp", "f32"),)
    B = BATCH // 2
    kids = rng.integers(0, N_KEYS, BATCH).astype(np.int32)
    pk = torch.from_numpy(lattice.pack_batch_host(
        BATCH, BATCH, kids, np.zeros(BATCH, np.int32), None,
        {"temp": rng.normal(20, 5, BATCH).astype(np.float32)},
        [None, None], lay1)).to(dev)
    # held against the plain version at that shape, both data shards'
    # blocks, on the timed batch and on one of the same shape with
    # padding, invalid records and both NULL masks set at random
    pk_nulls = torch.from_numpy(lattice.pack_batch_host(
        BATCH, BATCH - 5, kids, rng.integers(0, 1 << 20, BATCH)
        .astype(np.int32), rng.random(BATCH) < 0.9,
        {"temp": rng.normal(20, 5, BATCH).astype(np.float32)},
        [rng.random(BATCH) < 0.2, rng.random(BATCH) < 0.2], lay1)).to(dev)
    for batch in (pk, pk_nulls):
        for lo in (0, B):
            got = pl.unpack_block(batch, lo, B, lay1, nk1, [0, 512])
            want = pl.unpack_block_ref(batch, lo, B, lay1, nk1, [0, 512])
            torch.cuda.synchronize()
            for g, w, what in zip(got[:3], want[:3],
                                  ("keys", "ts", "valid")):
                assert torch.equal(g, w), \
                    f"sharded_step 2^19 block at {lo}: {what}"
            assert set(got[3]) == set(want[3])
            for k in want[3]:
                assert same_bits(got[3][k], want[3][k]), \
                    f"sharded_step 2^19 block at {lo}: {k}"
            n_cases += 1
    ms, call, src = kernel_ms(lambda: pl.unpack_block(
        pk, B, B, lay1, nk1, [0, 512]), 50)
    plain = kernel_ms(lambda: pl.unpack_block_ref(
        pk, B, B, lay1, nk1, [0, 512]), 5)[0]
    b_ms, b_by = bound(B * (4 + 4 + 1 + 2 + 2 * 4), B * 6)
    results["sharded_step"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/unpack.cu",
        replaces="hstream_tpu/parallel/lattice.py:173", paths=SH_PATHS,
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src)
    log(f"sharded_step: {n_cases} blocks (odd offsets, pitch {cap}; "
        f"both 2^19 blocks of a 2^20 batch) exact; {ms:.4f} ms a 2^19 block (plain {plain:.4f}, bound "
        f"{b_ms:.5f})")
    # -- B19a-close: the merged close, then B19a-touched and B19d
    specs = sharded_specs()
    n_close = n_touched = n_merge = 0
    for i, (name, spec) in enumerate(specs.items()):
        state = random_sharded_state(spec, dev, 300 + 10 * i)
        W = spec.n_slots
        vecs = [lattice.pad_slots([int(rng.integers(0, W))]),
                lattice.pad_slots(rng.permutation(W)[:min(W, 5)]
                                  .astype(np.int32))]
        for slots in vecs:
            for mode in (lattice.CLOSE_EXTRACT_RESET, lattice.CLOSE_EXTRACT,
                         lattice.CLOSE_RESET, lattice.CLOSE_EXTRACT_RESET):
                a, b = copy_sharded(state), copy_sharded(state)
                got = pl.close_merged(spec, a, slots, mode)
                want = pl.close_merged_ref(spec, b, slots, mode)
                torch.cuda.synchronize()
                if want is not None:
                    assert torch.equal(got, want), \
                        f"merged_close {name} {mode}: rows"
                assert sharded_equal(a, b), f"merged_close {name} {mode}"
                state = a
                n_close += 1
        state = random_sharded_state(spec, dev, 400 + 10 * i)
        for mode in (lattice.CLOSE_EXTRACT, lattice.CLOSE_RESET):
            slot = int(rng.integers(0, W))
            a, b = copy_sharded(state), copy_sharded(state)
            got = pl.close_slot_merged(spec, a, slot, mode)
            want = pl.close_slot_merged_ref(spec, b, slot, mode)
            torch.cuda.synchronize()
            if want is not None:
                assert torch.equal(got, want), f"merged slot {name}"
            assert sharded_equal(a, b), f"merged slot {name} {mode}"
            n_close += 1
        if spec.track_touched:
            for mo in (spec.n_keys * W, max(1, spec.n_keys * W // 5)):
                merged_touched_vs_plain(spec, state, mo, f"{name} {mo}")
                n_touched += 1
        got = pl.merge_partials(spec, state)
        want = pl.merge_partials_ref(spec, state)
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(got[k], want[k]), f"shard_merge {name}: {k}"
        n_merge += 1
    mesh_touched, mesh_close, mesh_merge = check_merged_meshes(dev)
    n_touched += mesh_touched
    n_close += mesh_close
    n_merge += mesh_merge
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor = kernel_only_ms(lambda: kb.check(kb.lib().hs_empty(stream),
                                            "empty"), 50, "empty",
                           expect=("empty",))
    # the merged close timed at config 1's shape: one due slot of the
    # four partials (K = 1024 in all), extract and reset; the extract-only
    # close of a pull apart
    spec = specs["config 1"]
    D, nk = SH_MESH
    st = random_sharded_state(spec, dev, 500)
    slots = lattice.pad_slots([0])
    ms, call, src = kernel_ms(lambda: pl.close_merged(spec, st, slots), 50)
    plain = kernel_ms(lambda: pl.close_merged_ref(
        spec, st, slots, lattice.CLOSE_EXTRACT_RESET), 5)[0]
    K = spec.n_keys * nk
    cell = 4 + 4 + 1024 + 1                        # count, sum, HLL, flag
    rows = 2 + len(spec.aggs)
    b_ms, b_by = bound(2 * D * K * cell + rows * K * 4, K * 1024 * 4)
    ms1, call1, src1 = kernel_ms(lambda: pl.close_merged(
        spec, st, slots, lattice.CLOSE_EXTRACT), 50)
    kinds = lattice.plane_merge_kinds(spec)
    lib = kernel_ms(lambda: stacked_merge(
        st, kinds, lambda v: v[:, 0] if v.dim() > 1 else v[:1]), 20)[0]
    results["merged_close"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/close.cu",
        replaces="hstream_tpu/parallel/lattice.py:273", paths=SH_PATHS,
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, call_ms=call, ms_source=src,
        library_what="torch.stack + sum/amin/amax of the slot column, "
                     "the merge alone",
        extract_only_ms=ms1, extract_only_call_ms=call1,
        launch_floor_ms=floor)
    log(f"merged_close: {n_close} cases (modes 0/1/2, per slot; "
        f"{list(BIG_MESHES)} in one launch) exact; "
        f"{ms:.4f} ms a config-1 slot over {D * nk} partials (plain "
        f"{plain:.4f}, the merge alone in torch.stack + sum/amin/amax "
        f"{lib:.4f}, bound {b_ms:.5f}, an empty kernel {floor}); extract "
        f"only {ms1:.4f} ms")
    # the merged changelog extract at the push query's shape: its flags
    # as one 2^20 batch of one second leaves them (one window's cells)
    spec = specs["push"]
    st = random_sharded_state(spec, dev, 600)
    W = spec.n_slots
    for row in st:
        for p in row:
            p["touched"].zero_()
            p["touched"][:, 0] = True
    mo = spec.n_keys * W
    n_t = spec.n_keys

    def touched_again():
        for row in st:
            for p in row:
                p["touched"][:, 0] = True
        return pl.touched_merged(spec, st, mo)

    # the extract's kernels alone (the re-touch's fill left out), one
    # launch at this shape
    call = cuda_time_ms(touched_again, 50)
    ms = kernel_only_ms(touched_again, 50, ("merged_", "Memset"),
                        expect=("merged_one_kernel",))
    src = "profiler" if ms is not None else "events"
    ms = call if ms is None else ms
    plain = kernel_ms(lambda: pl.touched_merged_ref(spec, st, mo), 5)[0]
    lib = kernel_ms(lambda: stacked_merge(
        st, lattice.plane_merge_kinds(spec), lambda v: v), 20)[0]
    rows = 3 + len(spec.aggs)
    b_ms, b_by = bound(2 * D * nk * spec.n_keys * W + D * nk * n_t * 8
                       + nk * rows * mo * 4, 0)
    results["merged_touched"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/touched.cu",
        replaces="hstream_tpu/parallel/lattice.py:297", paths=SH_PATHS,
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, call_ms=call, ms_source=src,
        launch_floor_ms=floor,
        library_what="torch.stack + sum/amax of the planes, the merge "
                     "alone")
    log(f"merged_touched: {n_touched} cases exact (meshes "
        f"{list(MERGED_MESHES + BIG_MESHES)}, one launch and staged); "
        f"{ms:.4f} ms at the push query's shape ({src}; plain {plain:.4f}, "
        f"the merge alone in torch.stack + sum/amax {lib:.4f}, bound "
        f"{b_ms:.5f}, an empty kernel {floor})")
    # the snapshot merge of config 1's four partials, every plane, in one
    # launch; then config 1's lattice (K = 1024) over make_mesh(2, 16)'s
    # 32 partials on the card
    spec = specs["config 1"]
    st = random_sharded_state(spec, dev, 700)
    kinds = lattice.plane_merge_kinds(spec)
    ms, call, src = kernel_ms(lambda: pl.merge_partials(spec, st), 20,
                              expect=("shard_merge_kernel",))
    plain = kernel_ms(lambda: pl.merge_partials_ref(spec, st), 5)[0]

    lib = kernel_ms(lambda: stacked_merge(st, kinds, lambda v: v), 20)[0]
    planes = len(st[0][0])
    # each partial's planes read once, the canonical ones written once;
    # slot_start of key shard 0's partials alone
    moved = (D + 1) * (nk * sum(v.nbytes for v in st[0][0].values())
                       - (nk - 1) * spec.n_slots * 4)
    b_ms, b_by = bound(moved, 0)
    del st
    spec16 = replace(spec, n_keys=64)
    st = random_sharded_state(spec16, dev, 710, (2, 16))
    ms16, call16, _src = kernel_ms(lambda: pl.merge_partials(spec16, st),
                                   20, expect=("shard_merge_kernel",))
    b16 = bound(3 * (16 * sum(v.nbytes for v in st[0][0].values())
                     - 15 * spec.n_slots * 4), 0)[0]
    del st
    results["shard_merge"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/shard_merge.cu",
        replaces="hstream_tpu/engine/snapshot.py:258", paths=SH_PATHS,
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, call_ms=call, ms_source=src,
        launch_floor_ms=floor, ms_2x16=ms16, call_ms_2x16=call16,
        bound_ms_2x16=b16)
    log(f"shard_merge: {n_merge} lattices exact ({list(BIG_MESHES)} in "
        f"one launch); {ms:.4f} ms a config-1 capture (one launch) of "
        f"{planes} planes (plain {plain:.4f}, "
        f"torch.stack + sum/amin/amax {lib:.4f}, bound {b_ms:.5f}, an empty "
        f"kernel {floor}); make_mesh(2, 16)'s capture {ms16:.4f} ms "
        f"(bound {b16:.5f})")


def _sharded_node(spec):
    from hstream_tpu_torch.engine import (AggregateNode, ColumnType, Schema,
                                          SourceNode)
    from hstream_tpu_torch.engine.expr import Col

    schema = Schema.of(device=ColumnType.STRING, temp=ColumnType.FLOAT)
    return AggregateNode(child=SourceNode("sensors", schema),
                         group_keys=[Col("device")], window=spec.window,
                         aggs=list(spec.aggs)), schema


def _same_rows(cfg, rows, single, per_key, size, ms=SH_MS,
               batches=SH_BATCHES) -> int:
    """The mesh's rows against the single-card executor's: keys, counts,
    HLL estimates, MIN and MAX exact, sums and averages within twice the
    summation-order bound of each against numpy (batches of `ms`)."""
    ref = {(r["device"], r["winStart"]): r for r in single}
    assert len(ref) == len(rows), (len(ref), len(rows))
    windows: dict = {}
    for r in rows:
        o = ref[(r["device"], r["winStart"])]
        k = int(r["device"][1:])
        w = windows.get(r["winStart"])
        if w is None:
            w = windows[r["winStart"]] = window_reference(
                per_key, r["winStart"], size, ms, batches)
        n = w["count"][k]
        lim = 4 * n * U * w["abs"][k]
        if cfg == 1:
            assert (r["cnt"], r["uniq"]) == (o["cnt"], o["uniq"]), (r, o)
            assert abs(r["total"] - o["total"]) <= lim, (r, o)
        else:
            assert (r["lo"], r["hi"]) == (o["lo"], o["hi"]), (r, o)
            assert abs(r["avg"] - o["avg"]) <= lim / n, (r, o)
    return len(rows)


def sharded_path(cfg: int, dev) -> dict:
    """14a: config cfg through ShardedQueryExecutor on a (2, 2) mesh whose
    four shards share the card, SH_BATCHES x 2^20 records (2^19 a data
    shard), then a closer: every closed row against numpy and the
    single-card QueryExecutor's, one merged close launch and one fetch a
    close cycle."""
    from hstream_tpu_torch.engine import QueryExecutor
    from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh

    spec = make_spec(cfg)
    node, schema = _sharded_node(spec)
    mesh = make_mesh(*SH_MESH)
    assert {str(d) for d in mesh.devices.flat} == {str(dev)}, mesh
    ex = ShardedQueryExecutor(node, schema, mesh=mesh, emit_changes=False,
                              initial_keys=1024, batch_capacity=BATCH)
    for k in range(N_KEYS):
        ex.key_id_for((f"d{k}",))
    src = Batches(seed=140 + cfg, ms=SH_MS)
    per_key = src.per_key()
    adv = spec.window.advance_ms
    boundary = (int(src.get(SH_BATCHES - 1)[1].max()) // adv + 1) * adv
    n = 4096
    closer = (np.arange(n, dtype=np.int32) % N_KEYS,
              np.full(n, boundary + 1, np.int64),
              {"temp": np.full(n, np.float32(21.5))})
    zero_counts()
    rows: list = []
    t0 = time.perf_counter()
    for b in range(SH_BATCHES):
        kids, ts, temps = src.get(b)
        rows.extend(ex.process_columnar(kids, ts, {"temp": temps}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    before = dict(ex.close_stats)
    out = list(ex.process_columnar(*closer))
    delta = {k: ex.close_stats[k] - before[k] for k in before}
    assert delta == {"close_cycles": 1, "close_dispatches": 1,
                     "close_fetches": 1}, delta
    assert len(out) == N_KEYS and all(r["winEnd"] == boundary for r in out)
    rows.extend(out)
    counts = launch_counts()
    stats = dict(ex.close_stats)
    size = spec.window.size_ms
    n_windows = check_rows(cfg, spec, rows, per_key, dev, ref_of=lambda s:
                           window_reference(per_key, s, size, SH_MS,
                                            SH_BATCHES))
    assert stats["close_cycles"] == stats["close_dispatches"] == \
        stats["close_fetches"] >= 2, stats
    steps = SH_BATCHES + 1
    assert counts["sharded_step"] == SH_MESH[0] * steps, counts
    assert counts["scatter_aggregate"] == SH_MESH[0] * SH_MESH[1] * steps, \
        counts
    assert counts["merged_close"] == stats["close_dispatches"], counts
    assert counts["wire_decode"] == counts["fused_close"] == \
        counts["touched_extract"] == counts["merged_touched"] == 0, counts
    single = QueryExecutor(node, schema, emit_changes=False,
                           initial_keys=1024, batch_capacity=BATCH)
    for k in range(N_KEYS):
        single.key_id_for((f"d{k}",))
    srows: list = []
    for b in range(SH_BATCHES):
        kids, ts, temps = src.get(b)
        srows.extend(single.process_columnar(kids, ts, {"temp": temps}))
    srows.extend(single.process_columnar(*closer))
    same = _same_rows(cfg, rows, srows, per_key, size)
    return dict(config=f"sharded {cfg}", launches=counts,
                events_per_sec=SH_BATCHES * BATCH / wall, wall_s=wall,
                windows_checked=n_windows, rows_equal_single_card=same,
                close_stats=stats, transfer_stats=ex.transfer_stats,
                device_plane_bytes=ex.device_plane_bytes())


WIDE_MESH = (1, 24)           # 24 key shards on the card: two unpacks
WIDE_MESH_BATCHES = 6         # 2^20-record batches of WIDE_MESH_MS
WIDE_MESH_MS = 4_000          # two windows close mid-run
WIDE_MESH_CAPTURE = 4         # batches before the capture


def sharded_wide_path(dev) -> dict:
    """14d: config 1 through ShardedQueryExecutor on make_mesh(1, 24)
    (past 16 partials on one card; K = 1536, 64 keys a key shard),
    WIDE_MESH_BATCHES x 2^20 records, then a closer: every row equal the
    single-card QueryExecutor's on the same batches, one merged close
    launch a close cycle; after WIDE_MESH_CAPTURE batches a snapshot of
    the mesh (one snapshot merge launch) restored onto one card, whose
    rows on the remaining batches equal the single-card executor's too."""
    from hstream_tpu_torch.engine import QueryExecutor
    from hstream_tpu_torch.engine import snapshot as snap
    from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh
    from hstream_tpu_torch.parallel import lattice as pl

    cfg = 1
    spec = make_spec(cfg)
    node, schema = _sharded_node(spec)
    mesh = make_mesh(*WIDE_MESH)
    ex = ShardedQueryExecutor(node, schema, mesh=mesh, emit_changes=False,
                              initial_keys=64 * WIDE_MESH[1],
                              batch_capacity=BATCH)
    single = QueryExecutor(node, schema, emit_changes=False,
                           initial_keys=1024, batch_capacity=BATCH)
    for k in range(N_KEYS):
        ex.key_id_for((f"d{k}",))
        single.key_id_for((f"d{k}",))
    src = Batches(seed=150, ms=WIDE_MESH_MS)
    per_key = src.per_key()
    adv = spec.window.advance_ms
    last = int(src.get(WIDE_MESH_BATCHES - 1)[1].max())
    n = 4096
    closer = (np.arange(n, dtype=np.int32) % N_KEYS,
              np.full(n, (last // adv + 1) * adv + 1, np.int64),
              {"temp": np.full(n, np.float32(21.5))})
    batches = [src.get(b) for b in range(WIDE_MESH_BATCHES)]
    batches = [(k, t, {"temp": x}) for k, t, x in batches] + [closer]
    zero_counts()
    card = pl.CARD_LAUNCHES["close_merged"]
    rows, srows, rrows = [], [], []
    restored = None
    t0 = time.perf_counter()
    for b, batch in enumerate(batches):
        if b == WIDE_MESH_CAPTURE:
            merges = pl.CARD_LAUNCHES["merge_partials"]
            blob = snap.snapshot_executor(ex)
            assert pl.CARD_LAUNCHES["merge_partials"] == merges + 1
            restored, _extra = snap.restore_executor(
                types.SimpleNamespace(node=node), blob, device=dev)
            assert not hasattr(restored, "_sharded")
        rows.extend(ex.process_columnar(*batch))
        srows.extend(out := single.process_columnar(*batch))
        if restored is not None:
            rrows.extend(restored.process_columnar(*batch))
        else:
            rrows.extend(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = dict(ex.close_stats)
    assert stats["close_cycles"] == stats["close_dispatches"] == \
        stats["close_fetches"] >= 3, stats
    assert pl.CARD_LAUNCHES["close_merged"] - card == \
        stats["close_dispatches"], stats
    steps = len(batches)
    assert counts["sharded_step"] == 2 * steps, counts    # 16 + 8 keys
    assert counts["merged_close"] == stats["close_dispatches"], counts
    assert counts["shard_merge"] == 1, counts
    size = spec.window.size_ms
    same = _same_rows(cfg, rows, srows, per_key, size, WIDE_MESH_MS,
                      WIDE_MESH_BATCHES)
    after = _same_rows(cfg, rrows, srows, per_key, size, WIDE_MESH_MS,
                       WIDE_MESH_BATCHES)
    assert same == after == len(srows) > 0, (same, after, len(srows))
    return dict(config="sharded 1x24", launches=counts,
                events_per_sec=WIDE_MESH_BATCHES * BATCH / wall,
                wall_s=wall, rows_equal_single_card=same,
                restored_rows_equal=after, blob_bytes=len(blob),
                close_stats=stats)


def sharded_push_path(dev) -> dict:
    """14b: bench.py:768's push query (COUNT(*), SUM(temp) EMIT CHANGES)
    on the (2, 2) mesh, SH_PUSH_BATCHES x 2^20 records: one merged
    changelog extract a batch, and every (key, window)'s last change
    against numpy (counts exact, sums within the bound)."""
    from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh

    spec = push_spec()
    node, schema = _sharded_node(spec)
    ex = ShardedQueryExecutor(node, schema, mesh=make_mesh(*SH_MESH),
                              emit_changes=True, initial_keys=1024,
                              batch_capacity=BATCH)
    for k in range(N_KEYS):
        ex.key_id_for((f"d{k}",))
    src = Batches(seed=143, ms=SH_MS)
    per_key = src.per_key()
    zero_counts()
    finals: dict = {}
    n_changes = 0
    t0 = time.perf_counter()
    for b in range(SH_PUSH_BATCHES):
        kids, ts, temps = src.get(b)
        for r in ex.process_columnar(kids, ts, {"temp": temps}):
            finals[(r["device"], r["winStart"])] = r
            n_changes += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    by_win: dict = {}
    for (_d, ws), r in finals.items():
        by_win.setdefault(ws, []).append(r)
    assert len(by_win) == -(-SH_PUSH_BATCHES * SH_MS // 10_000), by_win.keys()
    for ws, rs in by_win.items():
        ref = window_reference(per_key, ws, 10_000, SH_MS, SH_PUSH_BATCHES)
        keys = np.array([int(r["device"][1:]) for r in rs])
        assert len(rs) == N_KEYS == len(set(keys.tolist())), ws
        n = ref["count"][keys]
        assert (np.array([r["c"] for r in rs]) == n).all(), ws
        lim = 2 * n * U * ref["abs"][keys]
        assert (np.abs(np.array([r["s"] for r in rs]) - ref["sum"][keys])
                <= lim).all(), ws
    assert counts["merged_touched"] == SH_PUSH_BATCHES, counts
    assert counts["sharded_step"] == SH_MESH[0] * SH_PUSH_BATCHES, counts
    assert counts["merged_close"] > 0 and counts["touched_extract"] == 0, \
        counts
    return dict(config="sharded push", launches=counts,
                events_per_sec=SH_PUSH_BATCHES * BATCH / wall, wall_s=wall,
                change_rows=n_changes, windows_checked=len(by_win))


def sharded_server_path(dev) -> dict:
    """14c: serve(mesh_shape="2x2") on the card serving phase 13's view
    and push query over SH_SRV_BLOCKS framed blocks of 2^18 records, a
    pull query of the view and the push query's finals against numpy;
    then the view's snapshot taken on the mesh (the snapshot merge)
    restored onto one card, and that one's snapshot restored onto a mesh:
    both peeks equal numpy."""
    import grpc

    from hstream_tpu_torch.client.producer import ColumnarProducer
    from hstream_tpu_torch.common import records
    from hstream_tpu_torch.engine.snapshot import (restore_executor,
                                                   snapshot_executor)
    from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh
    from hstream_tpu_torch.proto import api_pb2 as pb
    from hstream_tpu_torch.proto.rpc import HStreamApiStub
    from hstream_tpu_torch.server.main import serve

    src = ServerStream(seed=13)
    frames = [src.frame(b) for b in range(SH_SRV_BLOCKS)]
    server, ctx = serve("127.0.0.1", 0, "mem://", mesh_shape="2x2")
    opts = [("grpc.max_receive_message_length", 64 << 20),
            ("grpc.max_send_message_length", 64 << 20)]
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}", options=opts)
    stub = HStreamApiStub(ch)
    try:
        assert ctx.mesh.shape == {"data": 2, "key": 2}, ctx.mesh
        stub.CreateStream(pb.Stream(stream_name="sensors"))
        stub.ExecuteQuery(pb.CommandQuery(stmt_text=SRV_VIEW))
        stub.CreateQuery(pb.CreateQueryRequest(query_text=SRV_PUSH,
                                               id=SRV_PUSH_ID))
        tasks = [_srv_task(ctx, "view-headline"), _srv_task(ctx, SRV_PUSH_ID)]
        zero_counts()
        t0 = time.perf_counter()
        resp = ColumnarProducer(ch, "sensors").append_stream_frames(
            iter(frames))
        assert resp.rows == SH_SRV_BLOCKS * SRV_BLOCK, resp.rows
        _srv_drained(tasks, src.last_ts(SH_SRV_BLOCKS - 1))
        wall = time.perf_counter() - t0
        for t in tasks:
            assert isinstance(t.executor, ShardedQueryExecutor), t.executor
            assert t.mesh_shards() == 2
        pulled = check_pull(_srv_pull(stub, pb, records), src, dev,
                            SH_SRV_BLOCKS, "the mesh pull")
        finals = check_push(ctx, src, dev, SH_SRV_BLOCKS)
        view = tasks[0]
        with view.state_lock:
            blob = snapshot_executor(view.executor)
        counts = launch_counts()
        ref = src.window(0, SH_SRV_BLOCKS)
        one, _ = restore_executor(view.plan, blob, device=dev)
        assert type(one).__name__ == "QueryExecutor" and one.device == dev
        check_server_window(one.peek(), ref, dev, "mesh snapshot on one card")
        back, _ = restore_executor(view.plan, snapshot_executor(one),
                                   mesh=make_mesh(*SH_MESH))
        assert isinstance(back, ShardedQueryExecutor)
        check_server_window(back.peek(), ref, dev,
                            "one-card snapshot on the mesh")
    finally:
        ch.close()
        server.stop(grace=1)
        ctx.shutdown()
    for name in ("sharded_step", "scatter_aggregate", "merged_close",
                 "merged_touched", "shard_merge"):
        assert counts[name] > 0, (name, counts)
    assert counts["wire_decode"] == counts["touched_extract"] == \
        counts["fused_close"] == 0, counts
    return dict(config="sharded server", launches=counts,
                events_per_sec=SH_SRV_BLOCKS * SRV_BLOCK / wall, wall_s=wall,
                pulled_windows=pulled, push_finals=finals,
                snapshot_bytes=len(blob))


# ---- phase 15: the key-sharded session arena and join stores ----------------

P15_SHARDS = 4               # 15a: make_mesh(1, 4), four key shards
P15_JOIN_MESH = (2, 2)       # 15b, 15c: the fused step's data routing runs
P15_SESS_BATCHES = 16        # 15a record mode, phase 7's stream and widths
P15_SEG_BATCHES = 12         # 15a segment mode: past the first closes
P15_KEY_CACHE = 110_000      # 15a: the key-cache bound, compactions mid-run
P15_JOIN_BATCHES = 12        # 15b: 10 device batches past activation
P15_SRV_BLOCKS = 16          # 15d: framed blocks of 2^18 session records
P15_SRV_USERS = 20_000
P15_KERNELS = ("sharded_session_step", "sharded_session_merge",
               "sharded_session_extract", "sharded_session_remap",
               "sharded_join_probe_insert", "sharded_join_probe_only",
               "sharded_join_probe_insert_step", "sharded_join_evict",
               "scatter_table_cuda")
# the wrappers capturing_sharded keeps a call of: the P15 kernels, and
# the merged changelog extract at 15b's inner lattice (B19a's second
# shape)
P15_CAPTURED = P15_KERNELS + ("touched_merged",)
P15_SESSION_PATHS = ("sharded session", "sharded session server")
P15_JOIN_PATHS = ("sharded join", "sharded fetch")

# the device events each phase-15 kernel's call must record (parts of
# their names): a profile that lacks one lost that kernel whole, and is
# not used (profiled_calls)
_PROBE = ("group_count_kernel", "group_scatter_kernel", "probe_window_kernel",
          "probe_bounds_kernel", "probe_expand_kernel")
P15_EVENTS = {
    "step": ("group_keys_kernel", "scan_dest", "group_init_copy_kernel",
             "group_record_scatter"),
    "merge": ("group_keys_kernel", "scan_dest", "group_init_copy_kernel",
              "group_fold_segments"),
    "extract": ("extract_table_kernel",),
    "remap": ("remap_table_kernel",),
    "join step": _PROBE + ("split_kernel", "merge_kernel", "scatter_table"),
    "scatter": ("scatter_table",),
    "evict": ("evict_kernel",),
    "probe insert": _PROBE + ("split_kernel", "merge_kernel"),
    "probe only": _PROBE,
    "touched": ("merged_touched_scan_kernel", "merged_finalize_kernel",
                "Memset")}

# phase 7's rows and phase 8's finals, the single-card executors'
# references for 15a and 15b (computed again where those phases did not
# run first)
SINGLE_CARD: dict = {}


def session_tuples(rows) -> set:
    """Closed sessions as (user, winStart, winEnd, p50 bits, p99 bits)."""
    return {(r["user"], int(r["winStart"]), int(r["winEnd"]),
             float(np.float32(r["p50"])), float(np.float32(r["p99"])))
            for r in rows}


@contextlib.contextmanager
def capturing_sharded(store: dict, armed: list):
    """As `capturing`, for the key-sharded wrappers of parallel/lattice.py
    (their callers look them up in the module at each call); a fresh
    output (the step's and merge's arenas, the stores `outs`) is not
    kept. The remap's and the eviction's first calls are kept whenever
    they come, and so is the probe-only redispatch's."""
    from hstream_tpu_torch.parallel import lattice as pl

    orig = {n: getattr(pl, n) for n in P15_CAPTURED}
    for n, fn in orig.items():
        drop = (2,) if n in ("sharded_session_step",
                             "sharded_session_merge") else ()
        always = n if n in ("sharded_session_remap", "sharded_join_evict",
                            "sharded_join_probe_only") else ""
        setattr(pl, n, _Capture(n, fn, store, armed, always, drop))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(pl, n, fn)


def _owned_packed(packed, S: int, s: int):
    """The packed batch as key shard s of S sees it: the valid bit of the
    records other shards own cleared (the reference's routing)."""
    p = packed.clone()
    own = torch.remainder(packed[0], S) == s
    p[2] = torch.where(own, packed[2], packed[2] & ~1)
    return p


def _owned_seg(seg, S: int, s: int):
    from hstream_tpu_torch.engine import session_lattice as sl

    out = dict(seg)
    own = (torch.remainder(seg["code"], S) == s) & \
        (seg["code"] < sl.SESSION_SENT_CODE)
    out["code"] = torch.where(own, seg["code"], sl.SESSION_SENT_CODE)
    return out


def sharded_step_vs_plain(spec, arenas, packed, inputs, gap, close_cut,
                          delta, what, tables=None) -> float:
    """The sharded step's kernels (one launch sequence over a table of
    the shards on the card; with `tables`, one over each of those lists
    of shards, as a card whose table splits takes them) against its
    plain version, each into fresh arenas; every shard held as
    check_session_arenas holds one arena. Returns the largest SUM/AVG
    error."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.parallel import lattice as pl

    S, cap = len(arenas), arenas[0]["code"].shape[0]

    def fresh():
        return [sl.init_session_arena(spec, cap, a["code"].device)
                for a in arenas]

    got, want = fresh(), fresh()
    if tables is None:
        before = pl.sharded_session_step.launches
        pl.sharded_session_step(spec, arenas, got, packed, inputs, gap,
                                close_cut, delta)
        assert pl.sharded_session_step.launches == before + 1
    else:
        assert sorted(sum(tables, [])) == list(range(S)), tables
        for shards in tables:
            sl.step_group_cuda(spec, arenas, got, shards, S, packed, inputs,
                               gap, close_cut, delta)
    pl.sharded_session_step_ref(spec, arenas, want, packed, inputs, gap,
                                close_cut, delta)
    ains = tuple(None if x is None else
                 (x.abs() if x.dtype == torch.float32 else x)
                 for x in inputs)
    err = 0.0
    for s in range(S):
        ps = _owned_packed(packed, S, s)
        absw = sl.init_session_arena(spec, cap, packed.device)
        sl.session_step_ref(spec, _abs_planes(spec, arenas[s]), absw, ps,
                            ains, gap, close_cut, delta)
        acode, at0, at1 = sl._retired(arenas[s], close_cut, delta)
        bcode = torch.where((ps[2] & 1) != 0, ps[0].long(),
                            sl.SESSION_SENT_CODE)
        ts = ps[1].long()
        dest = sl.chain_slots(torch.cat([acode, bcode]),
                              torch.cat([at0, ts]), torch.cat([at1, ts]),
                              gap, cap)
        torch.cuda.synchronize()
        err = max(err, check_session_arenas(spec, got[s], want[s],
                                            _terms(dest, cap), absw,
                                            f"{what}, shard {s}"))
        del absw
    return err


def sharded_merge_vs_plain(spec, arenas, seg, gap, close_cut, delta,
                           what, tables=None) -> float:
    """As sharded_step_vs_plain, for the segment-mode merge."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.parallel import lattice as pl

    S, cap = len(arenas), arenas[0]["code"].shape[0]

    def fresh():
        return [sl.init_session_arena(spec, cap, a["code"].device)
                for a in arenas]

    got, want = fresh(), fresh()
    if tables is None:
        before = pl.sharded_session_merge.launches
        pl.sharded_session_merge(spec, arenas, got, seg, gap, close_cut,
                                 delta)
        assert pl.sharded_session_merge.launches == before + 1
    else:
        assert sorted(sum(tables, [])) == list(range(S)), tables
        for shards in tables:
            sl.merge_group_cuda(spec, arenas, got, shards, S, seg, gap,
                                close_cut, delta)
    pl.sharded_session_merge_ref(spec, arenas, want, seg, gap, close_cut,
                                 delta)
    err = 0.0
    for s in range(S):
        ss = _owned_seg(seg, S, s)
        absw = sl.init_session_arena(spec, cap, seg["code"].device)
        sl.session_merge_ref(spec, _abs_planes(spec, arenas[s]), absw,
                             _abs_planes(spec, ss), gap, close_cut, delta)
        acode, at0, at1 = sl._retired(arenas[s], close_cut, delta)
        dest = sl.chain_slots(torch.cat([acode, ss["code"].long()]),
                              torch.cat([at0, ss["t0"].long()]),
                              torch.cat([at1, ss["t1"].long()]), gap, cap)
        torch.cuda.synchronize()
        err = max(err, check_session_arenas(spec, got[s], want[s],
                                            _terms(dest, cap), absw,
                                            f"{what}, shard {s}"))
    return err


def _residue_lut(codes: np.ndarray, S: int, lcap: int, rng) -> np.ndarray:
    """A residue-preserving compaction table over `codes` (the
    executors'): live codes renumbered rank * S + residue within their
    class, a third of them dead (the sentinel)."""
    lut = np.full(lcap, 1 << 22, np.int32)
    live = np.unique(codes)
    live = live[rng.random(len(live)) < 0.67]
    for s in range(S):
        m = live[live % S == s]
        lut[m] = np.arange(len(m)) * S + s
    return lut


def check_sharded_session(dev, results):
    """B19c against its plain versions on the card, four key shards on it:
    the step (every aggregate kind, NULL masks, invalid records, retired
    and evicted entries, a delta) and the merge, each over one table of
    the card's shards and over tables of some of them (a split table:
    the records of the others are dropped), then timed at 15a's shapes
    (time_p15_shapes); the extract over per-shard slot lists of different
    lengths (one shard none, a pad inside a prefix), over one table and
    split ones, its prefixes by value in the launch and uploaded; the
    remap through one residue-preserving table; codes, times, integer
    planes, histograms and registers exact, SUM/AVG within the order
    bound, the extract and remap bit-exact."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.engine.kernels import binding as kb
    from hstream_tpu_torch.parallel import lattice as pl
    from hstream_tpu_torch.parallel import make_mesh

    spec, _schema, layout, progs = session_spec_all()
    S, cap = P15_SHARDS, 1 << 13
    ssl = pl.ShardedSessionLattice(make_mesh(1, S), spec)
    first = session_batch(dev, spec, layout, 150, 1 << 14, 3000, 0)
    arenas = ssl.init_arena(cap)
    pl.sharded_session_step_ref(
        spec, ssl.init_arena(cap), arenas, first,
        sl.session_inputs(spec, layout, first, progs), SESS_GAP,
        -(1 << 30), 0)
    for s, a in enumerate(arenas):
        live = torch.nonzero(a["code"] < sl.SESSION_SENT_CODE).flatten()
        assert len(live) > 100 and bool(
            (a["code"][live] % S == s).all()), s
        a["code"][live[::9]] = sl.SESSION_SENT_CODE   # evicted entries
    t1 = torch.cat([a["t1"][a["code"] < sl.SESSION_SENT_CODE]
                    for a in arenas])
    close_cut = int(t1.median())
    second = session_batch(dev, spec, layout, 151, 1 << 14, 3000,
                           3 * SESS_GAP)
    second_in = sl.session_inputs(spec, layout, second, progs)
    err = sharded_step_vs_plain(spec, arenas, second, second_in, SESS_GAP,
                                close_cut, 37, "sharded_session_step")
    seg = session_seg(dev, spec, 152, 1 << 12, 3000, 2 * SESS_GAP)
    err_m = sharded_merge_vs_plain(spec, arenas, seg, SESS_GAP, close_cut,
                                   11, "sharded_session_merge")
    # tables of some of the card's shards (a table split past the
    # parameters, or a mesh over several cards): each drops the records
    # of the shards outside it
    for tables in ([[0, 2], [1, 3]], [[3], [0, 1, 2]]):
        what = f"tables {tables}"
        err = max(err, sharded_step_vs_plain(
            spec, arenas, second, second_in, SESS_GAP, close_cut, 37,
            f"sharded_session_step, {what}", tables))
        err_m = max(err_m, sharded_merge_vs_plain(
            spec, arenas, seg, SESS_GAP, close_cut, 11,
            f"sharded_session_merge, {what}", tables))
    # equal (code, start) entries at the int32 wrap, where their order
    # decides the chains: one table and a split one
    rng = np.random.default_rng(154)
    tcap, tn = 1 << 11, 1 << 12
    ties = [tie_wrap(spec, tcap, dev, rng, 40, 0, S, s)[0]
            for s in range(S)]
    tcodes = rng.integers(0, 40 * S, tn)
    t0s = torch.cat([a["t0"][:tcap // 2] for a in ties]).cpu().numpy()
    tts = np.where(rng.random(tn) < 0.5, rng.choice(t0s, tn),
                   tie_wrap_times(rng, tn)[0])
    tpacked = pack_session(dev, spec, layout, rng, tcodes, tts)
    tin = sl.session_inputs(spec, layout, tpacked, progs)
    tseg = {k: torch.cat([tie_wrap_seg(spec, tcap, 500, dev, 155 + s, S,
                                       s)[1][k] for s in range(S)])
            for k in seg}
    for tables in (None, [[0, 2], [1, 3]]):
        what = f"ties at the int32 wrap, tables {tables or 'one'}"
        err = max(err, sharded_step_vs_plain(
            spec, ties, tpacked, tin, SESS_GAP, -(1 << 30), 0,
            f"sharded_session_step, {what}", tables))
        err_m = max(err_m, sharded_merge_vs_plain(
            spec, ties, tseg, SESS_GAP, -(1 << 30), 0,
            f"sharded_session_merge, {what}", tables))
    rng = np.random.default_rng(153)
    branches = set()
    for pcap, named in ((2048, (1500, 0, 2048, 7)),
                        (8192, (8192, 0, 100, 5000))):
        slots = np.full((S, pcap), -1, np.int32)
        for s, n in enumerate(named):
            slots[s, :n] = rng.permutation(cap)[:n]
        slots[0, 3] = -1                   # a pad inside a named prefix
        for tables in (None, [[0, 2], [1, 3]], [[3], [0, 1, 2]]):
            for ks in tables or [list(range(S))]:
                n_live, _sel0, cat = pl.extract_plan(slots, ks)
                branches.add(4 * len(ks) * len(spec.aggs) + len(cat)
                             <= kb.SESS_XT_WORDS)
            with join_tables(tables, "extract_tables"):
                got = pl.sharded_session_extract(spec, arenas, slots)
            want = pl.sharded_session_extract_ref(spec, arenas, slots)
            torch.cuda.synchronize()
            assert got.shape == (S, 1 + len(spec.aggs), pcap)
            assert torch.equal(got, want), \
                f"sharded_session_extract differs ({named}, {tables})"
    assert branches == {True, False}, branches   # inline and uploaded
    lut = torch.from_numpy(_residue_lut(np.arange(3000), S, 4096, rng)
                           ).to(dev)
    remap_vs_plain([{"code": x["code"]} for x in arenas], lut,
                   f"{S} key shards")
    n_remap = 1 + check_remap_table(dev, rng)
    src = "hstream_tpu_torch/engine/kernels/csrc/"
    for name, file, line, e in (
            ("sharded_session_step", "session_step.cu", 669, err),
            ("sharded_session_merge", "session_merge.cu", 690, err_m),
            ("sharded_session_extract", "session_extract.cu", 716, 0.0),
            ("sharded_session_remap", "session_remap.cu", 730, 0.0)):
        results[name] = dict(
            route="cuda", source=src + file,
            replaces=f"hstream_tpu/parallel/lattice.py:{line}",
            paths=P15_SESSION_PATHS, max_abs_err=e)
    log(f"sharded session (B19c), {S} key shards: step and merge over one "
        f"table of the card's shards and over split tables (also with ties "
        f"at the int32 wrap) against the "
        f"plain versions (every kind; SUM/AVG max err {err:.3g} / "
        f"{err_m:.3g}, within the order bound; the rest exact), the extract "
        f"over {S} slot lists (1500, 0, 2048, 7 and 8192, 0, 100, 5000 "
        f"named; one table and split ones, the prefixes by value and "
        f"uploaded) and the remap through one residue-preserving table "
        f"({n_remap} cases, one launch each, {REMAP_SHARDS} key shards on "
        f"the card, planes at every offset of a 16-byte boundary): "
        f"bit-exact")
    time_p15_shapes(dev, results)


# key shards on one card of the remap's table launch in phase 3: 15a's,
# and past 16 (a table passed by value would have capped them at 16)
REMAP_SHARDS = (P15_SHARDS, 17, 24)


def remap_vs_plain(arenas, lut, what: str) -> None:
    """sharded_session_remap over clones of the arenas' code planes, one
    launch on the card (asserted), against session_remap_ref a shard:
    bit-exact, and no live code leaves its shard's residue."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.parallel import lattice as pl

    S = len(arenas)
    got = [{"code": x["code"].clone()} for x in arenas]
    want = [{"code": x["code"].clone()} for x in arenas]
    one_launch(pl.sharded_session_remap, got, lut)
    for x in want:
        sl.session_remap_ref(x, lut)
    torch.cuda.synchronize()
    for s in range(S):
        assert torch.equal(got[s]["code"], want[s]["code"]), \
            f"sharded_session_remap differs, {what}, shard {s}"
        c = got[s]["code"]
        assert bool((c[c < sl.SESSION_SENT_CODE] % S == s).all()), (what, s)


def check_remap_table(dev, rng) -> int:
    """The remap's table launch at 17 and 24 key shards on the card (past
    16), over planes of their own and over slices of one buffer at 0-3
    codes past a 16-byte boundary (heads of 3-0 codes, caps off four),
    codes below, at and above the table and the sentinel. Returns the
    cases."""
    from hstream_tpu_torch.engine import session_lattice as sl

    cases = 0
    for S in REMAP_SHARDS[1:]:
        cap, lcap = 3001, 2048
        codes = rng.integers(0, (lcap + 300) // S, (S, cap)) * S \
            + np.arange(S)[:, None]
        codes[rng.random((S, cap)) < 0.1] = sl.SESSION_SENT_CODE
        lut = torch.from_numpy(_residue_lut(codes[codes < lcap], S, lcap,
                                            rng)).to(dev)
        own = [{"code": torch.from_numpy(c.astype(np.int32)).to(dev)}
               for c in codes]
        pitch = (cap + 7) // 4 * 4
        buf = torch.zeros(S * pitch + 4, dtype=torch.int32, device=dev)
        sliced = []
        for s in range(S):
            at = s * pitch + s % 4
            buf[at:at + cap] = own[s]["code"]
            sliced.append({"code": buf[at:at + cap]})
        for arenas, what in ((own, "own planes"), (sliced, "sliced")):
            remap_vs_plain(arenas, lut, f"{S} key shards, {what}")
            cases += 1
    return cases


def p15_inputs(dev, seed: int = 23, cap: int = 1 << 15, n: int = 1 << 20,
               nseg: int = 50_000):
    """15a's shapes for the sharded session step and merge alone (also
    `ab.py session`): config 4's spec, P15_SHARDS key shards of 2^15 slots
    on the card (each a random_arena with codes that shard owns, 60 %
    of its slots the sentinel), a 2^20-record batch over 100,000 users
    (a second of times, |normal(50, 20)| latencies) and 50,000
    segments."""
    from hstream_tpu_torch.engine import session_lattice as sl

    node, _schema = session_plan()
    spec = sl.SessionSpec(aggs=tuple(node.aggs))
    layout = (("lat", "f32"),)
    rng = np.random.default_rng(seed)
    S = P15_SHARDS
    arenas = []
    for s in range(S):
        a = random_arena(spec, cap, dev, seed + 1 + s)
        code = rng.integers(0, SESS_USERS // S, cap) * S + s
        code[rng.random(cap) < 0.6] = sl.SESSION_SENT_CODE
        a["code"].copy_(torch.from_numpy(code.astype(np.int32)))
        arenas.append(a)
    packed = torch.from_numpy(sl.pack_batch_host(
        n, n, rng.integers(0, SESS_USERS, n).astype(np.int32),
        rng.integers(0, 1000, n), None,
        {"lat": np.abs(rng.normal(50, 20, n)).astype(np.float32)},
        [None, None], layout)).to(dev)
    inputs = sl.session_inputs(spec, layout, packed)
    seg = session_seg(dev, spec, seed + 9, nseg, SESS_USERS, 0)
    return spec, arenas, packed, inputs, seg


def p15_join_inputs(dev, seed: int = 31) -> dict:
    """15b's and 15c's shapes for the sharded join's kernels alone (also
    `ab.py join`), over P15_JOIN_MESH's two key shards:
      * "step": sharded_join_probe_insert_step's arguments: 2^22-slot
        stores a shard (the probed side 2^20 live entries, the probing
        side half that, over JOIN_KEYS keys and 4 s of stream), a
        2^20-record batch over the same keys and span, WITHIN 1 s,
        match_cap 2^21 a shard (~2.1 M matches), into a (2, 2) inner
        lattice of 2^19 keys (COUNT(*) by key, TUMBLE(10 s));
      * "probe": sharded_join_probe_insert's arguments at phase 8b's
        widths: 2^19-slot stores a shard (~12 entries a key over 32,000
        keys), a 2^16-record batch, WITHIN 10 s, match_cap 2^20 a shard;
      * "probe_only": sharded_join_probe_only's, the same batch and
        probed stores with match_cap 2^19 a shard (an overflow's redo at
        the batch's own width)."""
    from hstream_tpu_torch.engine import (AggKind, AggregateNode, AggSpec,
                                          ColumnType, Schema, SourceNode,
                                          TumblingWindow)
    from hstream_tpu_torch.engine.expr import Col
    from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh

    rng = np.random.default_rng(seed)
    S = P15_JOIN_MESH[1]

    def keyed(n, keys, span):
        c = rng.integers(0, keys, n).astype(np.int64)
        t = rng.integers(0, span, n).astype(np.int64)
        o = np.lexsort((t, c))
        return c[o], t[o]

    def stores(cap, n_live, keys, span):
        out = []
        for s in range(S):
            c, t = keyed(n_live, keys // S, span)
            code = np.full(cap, JOIN_SENT, np.int32)
            ts = np.zeros(cap, np.int32)
            code[:n_live], ts[:n_live] = c * S + s, t
            out.append({"code": torch.from_numpy(code).to(dev),
                        "ts": torch.from_numpy(ts).to(dev),
                        "flags": torch.full((cap,), 2, dtype=torch.int32,
                                            device=dev),
                        "cols": torch.zeros((0, cap), dtype=torch.int32,
                                            device=dev)})
        return out

    def batch(n, keys, span, inner_keys):
        b = np.zeros((4, n), np.int32)
        b[0], b[1] = keyed(n, keys, span)
        b[2], b[3] = b[0] % inner_keys, 2
        return torch.from_numpy(b).to(dev)

    schema = Schema.of(k=ColumnType.STRING)
    node = AggregateNode(child=SourceNode("s", schema),
                         group_keys=[Col("k")],
                         window=TumblingWindow(10_000, grace_ms=0),
                         aggs=[AggSpec(AggKind.COUNT_ALL, "c")])
    inner = ShardedQueryExecutor(node, schema,
                                 mesh=make_mesh(*P15_JOIN_MESH,
                                                devices=[dev]),
                                 initial_keys=1 << 19)
    n = 1 << 20
    step = (stores(1 << 22, 1 << 19, JOIN_KEYS, 4000),
            stores(1 << 22, 1 << 20, JOIN_KEYS, 4000),
            batch(n, JOIN_KEYS, 4000, 1 << 19), n, 1000, -(1 << 31),
            1 << 21, 0, inner._sharded.local_spec, inner.state, -1, 0,
            inner._sharded._progs, ((), (), ()))
    n = 1 << 16
    probe = (stores(1 << 19, 100_000, 32_000, 4000),
             stores(1 << 19, 200_000, 32_000, 4000),
             batch(n, 32_000, 4000, 1000), n, 10_000, -(1 << 31), 1 << 20,
             0)
    return {"step": step, "probe": probe,
            "probe_only": probe[1:6] + (1 << 19, 0)}


def p15_touched_inputs(dev, seed: int = 33, touched: int = 390_000):
    """The merged changelog extract at 15b's shape for `ab.py sharded`:
    the join's inner lattice (COUNT(*) by key, TUMBLE(10 s), K = 2^19)
    on P15_JOIN_MESH, `touched` of its cells (the join's ~390,000 live
    columns, run CJ) touched in data shard 0's partial, 1's or both,
    their counts 1 to 8; max_out Kl * W, as ShardedQueryExecutor sizes
    it. Returns (local spec, state, max_out)."""
    from hstream_tpu_torch.engine import (AggKind, AggSpec, TumblingWindow,
                                          lattice)
    from hstream_tpu_torch.parallel.lattice import ShardedState

    D, nk = P15_JOIN_MESH
    spec = lattice.LatticeSpec(
        n_keys=(1 << 19) // nk, window=TumblingWindow(10_000, grace_ms=0),
        aggs=(AggSpec(AggKind.COUNT_ALL, "c"),), track_touched=True)
    cells = spec.n_keys * spec.n_slots
    rng = np.random.default_rng(seed)
    hit = rng.choice(nk * cells, touched, replace=False)
    side = rng.integers(0, D + 1, touched)      # D: every data shard
    state = ShardedState()
    for d in range(D):
        row = []
        for k in range(nk):
            part = lattice.init_state(spec, dev)
            mine = hit[((side == d) | (side == D)) & (hit // cells == k)] \
                % cells
            flat = torch.from_numpy(mine).to(dev)
            part["touched"].view(-1)[flat] = True
            part["count"].view(-1)[flat] = torch.from_numpy(
                rng.integers(1, 9, len(mine)).astype(np.int32)).to(dev)
            part["slot_start"].copy_(torch.arange(
                spec.n_slots, device=dev, dtype=torch.int32) * 10_000)
            row.append(part)
        state.append(row)
    return spec, state, cells


def p15_extract_slots(arenas, seed: int = 34, named: int = 6250,
                      pcap: int = 8192) -> np.ndarray:
    """15a's closing slot lists for `ab.py sharded`: `named` slots over
    the shards (as 15a's close cycles name them, run FC), each shard's
    among its live entries in ascending order (the mirror's), padded to
    [n_shards, pcap]."""
    from hstream_tpu_torch.engine import session_lattice as sl

    rng = np.random.default_rng(seed)
    S = len(arenas)
    slots = np.full((S, pcap), -1, np.int32)
    for s, a in enumerate(arenas):
        live = torch.nonzero(a["code"] < sl.SESSION_SENT_CODE).flatten()
        n = named // S + (s < named % S)
        slots[s, :n] = np.sort(rng.choice(live.cpu().numpy(), n,
                                          replace=False))
    return slots


def time_p15_shapes(dev, results):
    """The sharded step and merge at 15a's shapes (p15_inputs) profiled
    early in the process, where the profiler keeps every event (late in
    the run it has dropped some, PERF.md runs FF and FI): the kernels
    line takes these device times where phase 15's own profile does not
    hold."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.parallel import lattice as pl

    spec, arenas, packed, inputs, seg = p15_inputs(dev)
    cap = arenas[0]["code"].shape[0]
    outs = [sl.init_session_arena(spec, cap, dev) for _ in arenas]
    for name, fn, events in (
            ("sharded_session_step", lambda: pl.sharded_session_step(
                spec, arenas, outs, packed, inputs, 5000, -(1 << 30), 0),
             P15_EVENTS["step"]),
            ("sharded_session_merge", lambda: pl.sharded_session_merge(
                spec, arenas, outs, seg, 5000, -(1 << 30), 0),
             P15_EVENTS["merge"])):
        ms, call, src = kernel_ms(fn, 10, expect=events)
        results[name]["early"] = dict(ms=ms, call_ms=call, ms_source=src,
                                      stages=stage_ms(fn, 3))
        log(f"{name} at 15a's shapes (phase 3): {ms:.4f} ms device "
            f"({src}), {call:.4f} ms a call; by stage "
            f"{json.dumps(results[name]['early']['stages'])}")
    # the remap's table launch over 15a's four code planes, through a
    # residue-preserving table as long as 15a's key cache bound
    S = len(arenas)
    codes = torch.cat([a["code"] for a in arenas]).cpu().numpy()
    lcap = 1 << (P15_KEY_CACHE - 1).bit_length()
    lut = torch.from_numpy(_residue_lut(codes[codes < lcap], S, lcap,
                                        np.random.default_rng(157))).to(dev)
    planes = [{"code": a["code"].clone()} for a in arenas]
    remap_vs_plain(planes, lut, "15a's shapes")
    ms, call, src = kernel_ms(lambda: pl.sharded_session_remap(planes, lut),
                              50, expect=P15_EVENTS["remap"])
    results["sharded_session_remap"]["early"] = dict(
        ms=ms, call_ms=call, ms_source=src, cap=cap, lcap=lcap)
    log(f"sharded_session_remap at 15a's shapes (phase 3): {S} x {cap} "
        f"codes through {lcap} entries, one launch: {ms:.4f} ms device "
        f"({src}), {call:.4f} ms a call")
    del outs, arenas, packed, inputs, seg


def _shard_store(dev, rng, cap, n_cols, n_live, S, s):
    """A sorted store of key shard s: join_store's codes c * S + s."""
    st = join_store(dev, rng, cap, n_cols, n_live)
    live = st["code"] < JOIN_SENT
    st["code"] = torch.where(live, st["code"] * S + s, st["code"])
    return st


def sharded_join_inner(dev, where: bool, mesh, keys: int = 8):
    """join_inner's query, sharded on `mesh` (`keys` divisible by its key
    shards)."""
    from hstream_tpu_torch.parallel import ShardedQueryExecutor

    single = join_inner(dev, where)
    return ShardedQueryExecutor(single.node, single.schema, mesh=mesh,
                                initial_keys=keys)


# the tables of S key shards on one card that check_sharded_join drives:
# one table, and tables split as a mesh over several cards (or past the
# parameters) splits them
JOIN_TABLES = {1: [None], 2: [None, [[1], [0]]], 3: [None, [[0, 2], [1]]],
               4: [None, [[0, 2], [1, 3]]]}


@contextlib.contextmanager
def join_tables(tables, which: str = "join_groups"):
    """For the block's duration parallel.lattice's `which` (join_groups,
    or extract_tables) gives `tables` (lists of shard indices, each on
    the first's card), as a table split past the parameters or a mesh
    over several cards splits the shards; its own tables where `tables`
    is None."""
    from hstream_tpu_torch.parallel import lattice as pl

    if tables is None:
        yield
        return
    groups = getattr(pl, which)
    setattr(pl, which, lambda devices: [(devices[ks[0]], list(ks))
                                        for ks in tables])
    try:
        yield
    finally:
        setattr(pl, which, groups)


def table_launches():
    """The table launches' counters: (grouping, probe, insert, scatter)."""
    from hstream_tpu_torch.engine import join_lattice as jl
    from hstream_tpu_torch.parallel import lattice as pl

    return (jl.group_cuda.launches, jl.probe_table_cuda.launches,
            jl.insert_table_cuda.launches, pl.scatter_table_cuda.launches)


def assert_one_sequence_a_card(before, tables, probe: bool, insert: bool,
                               scatter: bool, what: str) -> None:
    """One launch sequence a table (one a card unless split): a grouping,
    a probe and an insert each, one scatter for the card's partials."""
    n = len(tables) if tables else 1
    want = (before[0] + n, before[1] + (n if probe else 0),
            before[2] + (n if insert else 0), before[3] + int(scatter))
    assert table_launches() == want, (what, before, table_launches(), want)


def sharded_fused_vs_plain(args, what, tables=None) -> int:
    """One fused sharded call (sharded_join_probe_insert_step's positional
    `args`) with the kernels (one launch sequence a table: `tables`, or
    one over the card's shards) and with the plain version, each on its
    own clone of the inner partials (args[9]) and into its own stores:
    the stores, the per-shard totals and every partial's planes exact
    (the inputs sum exactly in any order). Returns the match total."""
    from hstream_tpu_torch.parallel import lattice as pl

    mine, state = args[0], args[9]
    runs = []
    for fn in (pl.sharded_join_probe_insert_step,
               pl.sharded_join_probe_insert_step_ref):
        st = _clone(state)
        kw = ({"outs": [jl_empty(x) for x in mine]}
              if fn is pl.sharded_join_probe_insert_step else {})
        before = table_launches()
        with join_tables(tables):
            new, totals = fn(*args[:9], st, *args[10:], **kw)
        if fn is pl.sharded_join_probe_insert_step:
            assert_one_sequence_a_card(before, tables, True, True, True,
                                       what)
        runs.append((new, totals.cpu(), st))
    torch.cuda.synchronize()
    (gm, gt, gs), (wm, wt, ws) = runs
    assert torch.equal(gt, wt), f"{what}: totals differ {gt} {wt}"
    for s, (g, w) in enumerate(zip(gm, wm)):
        assert stores_equal(w, g), f"{what}: shard {s}'s insert differs"
    for d in range(ws.n_data):
        for k in range(ws.n_key):
            for name, v in ws[d][k].items():
                assert torch.equal(gs[d][k][name], v), \
                    f"{what}: partial ({d}, {k}) {name} differs"
    return int(wt.sum())


def jl_empty(st):
    from hstream_tpu_torch.engine import join_lattice as jl

    return jl.empty_join_store(st["code"].shape[0], st["cols"].shape[0],
                               st["code"].device)


def sharded_probe_vs_plain(mines, others, batch, n, mc, nm, cutoff, tables,
                           what) -> None:
    """The table probe + insert and probe-only (one launch sequence a
    table) against the reference's plan in plain PyTorch (each shard's
    owned mask over the whole batch): match buffers and stores exact."""
    from hstream_tpu_torch.parallel import lattice as pl

    S = len(mines)
    before, calls = table_launches(), pl.sharded_join_probe_insert.launches
    with join_tables(tables):
        new, packed = pl.sharded_join_probe_insert(
            mines, others, batch, n, JOIN_WITHIN, cutoff, mc, nm,
            outs=[jl_empty(x) for x in mines])
    assert pl.sharded_join_probe_insert.launches == calls + 1
    assert_one_sequence_a_card(before, tables, True, True, False, what)
    want_new = pl.sharded_join_insert_ref(mines, batch, n, nm)
    want_pk = pl.sharded_join_probe_ref(others, batch, n, JOIN_WITHIN,
                                        cutoff, mc, nm)
    before = table_launches()
    with join_tables(tables):
        only = pl.sharded_join_probe_only(others, batch, n, JOIN_WITHIN,
                                          cutoff, 2 * mc, nm)
    assert_one_sequence_a_card(before, tables, True, False, False, what)
    want_only = pl.sharded_join_probe_ref(others, batch, n, JOIN_WITHIN,
                                          cutoff, 2 * mc, nm)
    torch.cuda.synchronize()
    assert packed.shape == want_pk.shape == (packed.shape[0], S * mc)
    assert torch.equal(packed, want_pk), f"sharded probe {what}"
    assert torch.equal(only, want_only), f"sharded probe-only {what}"
    for s in range(S):
        assert stores_equal(want_new[s], new[s]), \
            f"sharded insert {what} shard {s}"


def check_sharded_join(dev, results):
    """B19b against its plain versions on the card (the reference's plan:
    every shard over the whole batch with its owned mask), one launch
    sequence a table asserted through the table counters: the probe +
    insert and the probe-only over S = 1-4 key shards in one table and
    in split tables (the match buffers in the reference's [rows, S *
    match_cap] layout, a truncating match_cap, n = 0, negative times, a
    shard without records); the fused step into inner lattices on
    (D, K) meshes (both feed layouts, with and without a WHERE, one
    table and split ones, the split tables driven through join_tables);
    the table scatter alone over split tables of partials and over a
    (2, 40) mesh's 80 partials in scatter_groups' tables; the eviction of
    every shard with live counts [4, 2]. Everything exact."""
    from hstream_tpu_torch.parallel import lattice as pl
    from hstream_tpu_torch.parallel import make_mesh

    n_pi = 0
    for S, tab_list in JOIN_TABLES.items():
        for i, (cap, bcap, n, nm, no, mc, cutoff) in enumerate(
                [(256, 64, 50, 3, 3, 512, -(1 << 31)),
                 (256, 64, 64, 3, 3, 8, -30),           # truncated shards
                 (256, 64, 0, 0, 3, 64, 0),             # n = 0
                 (1 << 16, 5000, 5000, 2, 1, 1 << 16, -30)]):
            rng = np.random.default_rng(400 + 10 * S + i)
            mines = [_shard_store(dev, rng, cap, nm, cap // 3, S, s)
                     for s in range(S)]
            others = [_shard_store(dev, rng, cap, no, cap // 2, S, s)
                      for s in range(S)]
            batch = join_batch(dev, rng, bcap, n, nm, codes=6 * S)
            if i == 1 and S > 1:   # shard 1 owns no record
                code = batch[0]
                batch[0] = torch.where((code < JOIN_SENT)
                                       & (code % S == 1), code - 1, code)
                batch = batch[:, torch.from_numpy(np.lexsort((
                    batch[1].cpu().numpy(),
                    batch[0].cpu().numpy()))).to(dev)].contiguous()
            for tables in tab_list:
                sharded_probe_vs_plain(mines, others, batch, n, mc, nm,
                                       cutoff, tables,
                                       f"S = {S} case {i} tables {tables}")
                n_pi += 1
    n_fused = 0
    for (D, K), keys, tab_list in (((2, 2), 8, [None, [[1], [0]]]),
                                   ((1, 3), 12, [None, [[0, 2], [1]]]),
                                   ((1, 4), 8, [None, [[0, 2], [1, 3]]]),
                                   ((2, 1), 8, [None])):
        mesh = make_mesh(D, K)
        for feed_name in JOIN_FEEDS:
            for where in (False, True):
                rng = np.random.default_rng(410 + where + 3 * K)
                inner = sharded_join_inner(dev, where, mesh, keys)
                cap, bcap, n, mc = 1 << 12, 1000, 1000, 1 << 14
                args = ([_shard_store(dev, rng, cap, 3, cap // 3, K, s)
                         for s in range(K)],
                        [_shard_store(dev, rng, cap, 3, cap // 2, K, s)
                         for s in range(K)],
                        join_batch(dev, rng, bcap, n, 3, codes=6 * K), n,
                        JOIN_WITHIN, -30, mc, 3, inner._sharded.local_spec,
                        inner.state, 120, 300, inner._sharded._progs,
                        join_feed(feed_name, inner, where))
                for tables in tab_list:
                    total = sharded_fused_vs_plain(
                        args, f"sharded_join_probe_step ({D}, {K}) "
                        f"{feed_name} where={where} tables {tables}",
                        tables)
                    assert total > 0
                    n_fused += 1
    # the table scatter alone: every entry routed by i mod n_data and kid
    # div Kl, split tables of partials, keys outside every key shard; a
    # (2, 40) mesh past one table's place span in scatter_groups' tables
    for (D, K), keys in (((2, 2), 8), ((2, 40), 80)):
        inner = sharded_join_inner(dev, False, make_mesh(D, K), keys)
        spec = inner._sharded.local_spec
        rng = np.random.default_rng(420 + (K > 2))
        m = 5000
        kid = torch.from_numpy(rng.integers(-5, K * spec.n_keys + 5, m)
                               .astype(np.int32)).to(dev)
        ts = torch.from_numpy(rng.integers(0, 500, m)
                              .astype(np.int32)).to(dev)
        valid = torch.from_numpy(rng.random(m) < 0.7).to(dev)
        cols = {c: torch.from_numpy((rng.integers(-40, 40, m) / 4)
                                    .astype(np.float32)).to(dev)
                for c in ("a", "b", "c")}
        tab_list = ([[(0, 0), (0, 1), (1, 0), (1, 1)]],
                    [[(1, 1), (0, 0)], [(0, 1)], [(1, 0)]]) if K == 2 else \
            ([ps for _d, ps in pl.scatter_groups(
                inner.state, len(pl._scatter_aggs(spec)))],)
        for tables in tab_list:
            got, want = _clone(inner.state), _clone(inner.state)
            before = pl.scatter_table_cuda.launches
            for parts in tables:
                pl.scatter_table_cuda(spec, got, parts, 120, kid, ts, valid,
                                      cols)
                pl.scatter_table_ref(spec, want, parts, 120, kid, ts, valid,
                                     cols)
            assert pl.scatter_table_cuda.launches == before + len(tables)
            torch.cuda.synchronize()
            for d in range(D):
                for k in range(K):
                    for name, v in want[d][k].items():
                        assert torch.equal(got[d][k][name], v), \
                            f"scatter_table ({D}, {K}) {tables} ({d}, {k}) " \
                            f"{name}"
            assert int(want[D - 1][K - 1]["count"].sum()) > 0
    S = P15_SHARDS
    n_ev = 0
    for i, (cap, cutoff, delta, nl, nr) in enumerate(EVICT_CASES[:7]):
        rng = np.random.default_rng(430 + i)
        lefts = [_shard_store(dev, rng, cap, 3, nl, S, s) for s in range(S)]
        rights = [_shard_store(dev, rng, cap, 1, nr, S, s) for s in range(S)]
        wl, wr, wn = pl.sharded_join_evict_ref(lefts, rights, cutoff, delta)
        gl, gr, gn = pl.sharded_join_evict(
            lefts, rights, cutoff, delta,
            outs=([jl_empty(x) for x in lefts], [jl_empty(x) for x in rights]))
        torch.cuda.synchronize()
        assert gn.shape == (S, 2) and torch.equal(gn, wn), \
            f"sharded evict counts, case {i}"
        for s in range(S):
            assert stores_equal(wl[s], gl[s]) and stores_equal(wr[s], gr[s]),\
                f"sharded evict case {i} shard {s}"
        n_ev += 1
    src = "hstream_tpu_torch/engine/kernels/csrc/"
    for name, file, line in (
            ("sharded_join_probe_insert", "join_probe.cu", 394),
            ("sharded_join_probe_only", "join_probe.cu", 420),
            ("sharded_join_probe_step", "join_probe.cu", 470),
            ("sharded_join_evict", "join_evict.cu", 441),
            ("sharded_join_scatter", "scatter.cu", 495)):
        results[name] = dict(
            route="cuda", source=src + file,
            replaces=f"hstream_tpu/parallel/lattice.py:{line}",
            paths=P15_JOIN_PATHS, max_abs_err=0.0)
    results["sharded_join_probe_insert"]["sources"] = [
        "join_group.cu", "join_probe.cu (table, pack mode)",
        "join_insert.cu (table)"]
    results["sharded_join_probe_only"]["sources"] = [
        "join_group.cu", "join_probe.cu (table, pack mode)"]
    results["sharded_join_probe_step"]["sources"] = [
        "join_group.cu", "join_probe.cu (table, feed mode)", "expr.cu",
        "scatter.cu (table)", "join_insert.cu (table)"]
    log(f"sharded join (B19b), 1-4 key shards in one table and in split "
        f"tables: {n_pi} probe + insert and probe-only cases (a truncating "
        f"match_cap, n = 0, a shard without records), {n_fused} fused "
        f"steps into inner lattices on (2, 2), (1, 3), (1, 4) and (2, 1) "
        f"meshes (both feeds, WHERE or not), the table scatter over split "
        f"tables of partials and over a (2, 40) mesh's 80 partials in "
        f"scatter_groups' tables, and {n_ev} evictions against the plain "
        f"versions: match buffers, stores, totals, counts and partials "
        f"exact; one launch sequence a table")


def _same_rows_single(kind: str, rows, wm: int, n: int, mode: str) -> int:
    """15a's closed sessions against the single-card executor's: phase
    7's rows (the same stream), those closed by this run's watermark."""
    gap = SESS_GAP
    ref = SINGLE_CARD.get("session")
    if ref is None:        # phase 7 did not run first
        from hstream_tpu_torch.engine import SessionExecutor

        node, schema = session_plan()
        ex = SessionExecutor(node, schema)
        ex.device_session_mode = mode
        src = SessionStream(seed=11, n_batches=n)
        out = []
        for b in range(n):
            out.extend(ex.process_columnar(*src.get(b)))
        out.extend(ex.drain_closed())
        ref = session_tuples(out)
    want = {r for r in ref if r[2] - gap + 2 * gap <= wm}
    got = session_tuples(rows)
    assert got == want, (kind, len(got), len(want),
                         sorted(got ^ want)[:4])
    return len(got)


def sharded_session_path(dev, results) -> dict:
    """15a: config 4 at phase 7's widths (100,000 user slots, 2^20 records
    a batch, 1 s a batch, the same stream) through SessionExecutor on
    make_mesh(1, 4), four key shards on the card: P15_SESS_BATCHES in
    record mode (the key cache bound lowered, so the residue-preserving
    compaction runs mid-run) and P15_SEG_BATCHES in segment mode; every
    closed session against numpy and the single-card executor's."""
    from hstream_tpu_torch.engine import SessionExecutor
    from hstream_tpu_torch.engine.sketches import QuantileConfig
    from hstream_tpu_torch.parallel import make_mesh

    qcfg = QuantileConfig()
    src = SessionStream(seed=11, n_batches=P15_SESS_BATCHES)
    ref = session_reference(src, P15_SESS_BATCHES, qcfg)
    ref_seg = session_reference(src, P15_SEG_BATCHES, qcfg)
    mesh = make_mesh(1, P15_SHARDS)
    assert {str(d) for d in mesh.devices.flat} == {str(dev)}, mesh
    captured: dict = {}

    def run(mode: str, n: int):
        node, schema = session_plan()
        ex = SessionExecutor(node, schema, mesh=mesh)
        ex.defer_close_decode = True
        ex.device_session_mode = mode
        ex._KEY_CACHE_MAX = P15_KEY_CACHE
        rows: list = []
        armed = [False]
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capturing_sharded(captured, armed):
            for b in range(n):
                armed[0] = b >= n - 3
                rows.extend(ex.process_columnar(*src.get(b)))
                if (b + 1) % SESS_DRAIN_EVERY == 0 or b == n - 1:
                    rows.extend(ex.drain_closed())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return ex, rows, wall, launch_counts()

    ex, rows, wall, counts = run("record", P15_SESS_BATCHES)
    st = dict(ex.session_stats)
    assert ex.device_fallbacks == 0 and ex._dev["ssl"].n_shards == P15_SHARDS
    assert counts["sharded_session_step"] == st["step_dispatches"] == \
        P15_SESS_BATCHES, (counts, st)
    assert counts["sharded_session_extract"] == st["close_dispatches"] \
        >= 2, (counts, st)
    assert counts["sharded_session_remap"] == st["remap_dispatches"] >= 1, \
        (counts, st)
    assert counts["session_step"] == counts["session_extract"] == \
        counts["session_remap"] == 0, counts
    assert ex.sharded_dispatches == P15_SESS_BATCHES + \
        st["close_dispatches"] + st["remap_dispatches"]
    check = check_session_rows(rows, ref, qcfg)
    same = _same_rows_single("record", rows, ref["wm"], P15_SESS_BATCHES,
                             "record")
    exs, rows_s, wall_s, counts_s = run("segment", P15_SEG_BATCHES)
    assert counts_s["sharded_session_merge"] == P15_SEG_BATCHES, counts_s
    assert counts_s["sharded_session_step"] == 0, counts_s
    check_s = check_session_rows(rows_s, ref_seg, qcfg)
    same_s = _same_rows_single("segment", rows_s, ref_seg["wm"],
                               P15_SESS_BATCHES, "segment")
    launches = {k: counts[k] + counts_s[k] for k in counts}
    time_sharded_session(dev, results, captured)
    return dict(config="sharded session", launches=launches,
                events_per_sec=P15_SESS_BATCHES * BATCH / wall, wall_s=wall,
                rows=len(rows), check=check, rows_equal_single_card=same,
                session_stats=st, arena_bytes=sum(
                    ex.device_plane_bytes().values()),
                host_stage_s=dict(ex.stage_stats),
                segment=dict(events_per_sec=P15_SEG_BATCHES * BATCH / wall_s,
                             rows=len(rows_s), check=check_s,
                             rows_equal_single_card=same_s,
                             session_stats=dict(exs.session_stats)))


def _early_if_lost(results, name, timed):
    """(ms, call_ms, source) of phase 15's kernel_ms, or, where its
    profile lost events ("events": ms is then the call time), the device
    ms that phase 3 profiled at 15a's shapes (time_p15_shapes)."""
    ms, call, src = timed
    early = results[name].get("early", {})
    if src == "events" and early.get("ms_source") == "profiler":
        return early["ms"], call, "profiler, phase 3 at 15a's shapes"
    return ms, call, src


def time_sharded_session(dev, results, captured):
    """Each B19c kernel on 15a's own inputs (one call of each, kept by the
    run), held against its plain version on them and timed beside it,
    with its bound and a PyTorch yardstick."""
    from hstream_tpu_torch.engine import session_lattice as sl
    from hstream_tpu_torch.parallel import lattice as pl

    missing = [k for k in P15_KERNELS[:4] if k not in captured]
    assert not missing, f"15a made no call of {missing}"
    spec, arenas, _, packed, inputs, gap, cc, delta = \
        captured["sharded_session_step"]
    S, cap, nb = len(arenas), arenas[0]["code"].shape[0], packed.shape[1]
    err = sharded_step_vs_plain(spec, arenas, packed, inputs, gap, cc, delta,
                                "sharded_session_step at 15a's shapes")
    outs = [sl.init_session_arena(spec, cap, dev) for _ in range(S)]
    ms, call, srcm = _early_if_lost(results, "sharded_session_step",
                                    kernel_ms(lambda: pl.sharded_session_step(
                                        spec, arenas, outs, packed, inputs,
                                        gap, cc, delta), 10,
                                        expect=P15_EVENTS["step"]))
    plain = kernel_ms(lambda: pl.sharded_session_step_ref(
        spec, arenas, outs, packed, inputs, gap, cc, delta), 1)[0]
    keys = [torch.cat([sort_keys(a["code"], a["t0"]),
                       sort_keys(packed[0], packed[1])]) for a in arenas]
    lib = kernel_ms(lambda: [torch.sort(k) for k in keys], 5)[0]
    b_ms, b_by = bound(2 * sum(_arena_bytes(a) for a in arenas)
                       + int(packed.nbytes), S * (cap + nb))
    results["sharded_session_step"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=cap, nb=nb, shards=S,
        max_abs_err=max(err, results["sharded_session_step"]["max_abs_err"]))
    log(f"sharded_session_step at 15a's {S} x {cap} slots and {nb} records: "
        f"kernels and plain agree (SUM/AVG max err {err:.3g}); {ms:.4f} ms "
        f"(plain {plain:.4f}, {S} torch.sort {lib:.4f}, bound {b_ms:.4f} by "
        f"{b_by})")
    del outs, keys

    spec, arenas, _, seg, gap, cc, delta = captured["sharded_session_merge"]
    cap, ns = arenas[0]["code"].shape[0], seg["code"].shape[0]
    err = sharded_merge_vs_plain(spec, arenas, seg, gap, cc, delta,
                                 "sharded_session_merge at 15a's shapes")
    outs = [sl.init_session_arena(spec, cap, dev) for _ in range(S)]
    ms, call, srcm = _early_if_lost(results, "sharded_session_merge",
                                    kernel_ms(lambda: pl.sharded_session_merge(
                                        spec, arenas, outs, seg, gap, cc,
                                        delta), 10,
                                        expect=P15_EVENTS["merge"]))
    plain = kernel_ms(lambda: pl.sharded_session_merge_ref(
        spec, arenas, outs, seg, gap, cc, delta), 1)[0]
    keys = [torch.cat([sort_keys(a["code"], a["t0"]),
                       sort_keys(seg["code"], seg["t0"])]) for a in arenas]
    lib = kernel_ms(lambda: [torch.sort(k) for k in keys], 5)[0]
    b_ms, b_by = bound(2 * sum(_arena_bytes(a) for a in arenas)
                       + _arena_bytes(seg), S * (cap + ns))
    results["sharded_session_merge"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=cap, nseg=ns, shards=S,
        max_abs_err=max(err, results["sharded_session_merge"]["max_abs_err"]))
    log(f"sharded_session_merge at 15a's {S} x {cap} slots and {ns} "
        f"segments: kernels and plain agree (SUM/AVG max err {err:.3g}); "
        f"{ms:.4f} ms (plain {plain:.4f}, {S} torch.sort {lib:.4f}, bound "
        f"{b_ms:.4f} by {b_by})")
    del outs, keys

    spec, arenas, slots = captured["sharded_session_extract"]
    got = pl.sharded_session_extract(spec, arenas, slots)
    want = pl.sharded_session_extract_ref(spec, arenas, slots)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "sharded_session_extract at 15a's shapes"
    ms, call, srcm = kernel_ms(lambda: pl.sharded_session_extract(
        spec, arenas, slots), 30, expect=P15_EVENTS["extract"])
    plain = kernel_ms(lambda: pl.sharded_session_extract_ref(
        spec, arenas, slots), 3)[0]
    n_sel = int((slots >= 0).sum())
    per_slot = _arena_bytes(arenas[0]) // arenas[0]["code"].shape[0]
    b_ms, b_by = bound(n_sel * per_slot + slots.nbytes + got.nbytes,
                       n_sel * 2 * spec.qcfg.n_bins)
    results["sharded_session_extract"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, call_ms=call, ms_source=srcm, slots=n_sel,
        padded=list(slots.shape))
    log(f"sharded_session_extract of 15a's {n_sel} closing slots "
        f"({list(slots.shape)} with pads): bit-exact against plain; "
        f"{ms:.4f} ms ({srcm}; a call {call:.4f}; plain {plain:.4f}, bound "
        f"{b_ms:.5f} by {b_by})")

    arenas, lut = captured["sharded_session_remap"]
    codes = [{"code": a["code"].clone()} for a in arenas]
    want = [{"code": a["code"].clone()} for a in arenas]
    pl.sharded_session_remap(codes, lut)
    for w in want:
        sl.session_remap_ref(w, lut)
    torch.cuda.synchronize()
    assert all(torch.equal(c["code"], w["code"])
               for c, w in zip(codes, want)), \
        "sharded_session_remap at 15a's shapes"
    ms, call, srcm = _early_if_lost(
        results, "sharded_session_remap",
        kernel_ms(lambda: pl.sharded_session_remap(codes, lut), 50,
                  expect=P15_EVENTS["remap"]))
    plain = kernel_ms(lambda: [sl.session_remap_ref(c, lut)
                               for c in codes], 10)[0]
    lcap = lut.shape[0]
    lib = kernel_ms(lambda: [lut[c["code"].clamp(0, lcap - 1).long()]
                             for c in codes], 10)[0]
    rcap = codes[0]["code"].shape[0]
    b_ms, b_by = bound(3 * len(codes) * rcap * 4, len(codes) * rcap)
    results["sharded_session_remap"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=rcap, lcap=lcap)
    log(f"sharded_session_remap of 15a's {len(codes)} x {rcap} codes "
        f"through its {lcap}-entry table: exact against plain; {ms:.4f} ms "
        f"(plain {plain:.4f}, indexing {lib:.4f}, bound {b_ms:.6f})")


def _join_mesh_executor(plan, batch: int, mesh):
    from hstream_tpu_torch.engine import JoinExecutor
    from hstream_tpu_torch.sql import make_executor

    ex = make_executor(plan, sample_rows=[{"k": "k0", "x": 1.0}],
                       batch_capacity=4 * batch, mesh=mesh)
    assert isinstance(ex, JoinExecutor) and ex.mesh is mesh
    ex.defer_change_decode = True     # bench.py's knobs, as phase 8
    ex.change_drain_depth = 8
    ex.async_change_drain = True
    return ex


def sharded_join_path(dev, captured) -> dict:
    """15b: config 5 at phase 8's widths (2^20 records a batch over
    512,000 keys, phase 8's stream) through JoinExecutor on
    make_mesh(2, 2): both stores key-sharded over two key shards, the
    fused step into the (2, 2) inner lattice (its data-shard routing),
    P15_JOIN_BATCHES batches; every final change against numpy and
    against the single-card executor's after as many batches."""
    from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh

    src = JoinStream(5, JOIN_BATCH, JOIN_KEYS, with_x=False)
    mesh = make_mesh(*P15_JOIN_MESH)
    ex = _join_mesh_executor(join_plan(), JOIN_BATCH, mesh)
    log_ = ChangeLog(src.keys)
    armed = [False]
    zero_counts()
    call_s = []
    with capturing_sharded(captured, armed):
        for b in range(P15_JOIN_BATCHES):
            armed[0] = b == P15_JOIN_BATCHES - 1
            ts, cols, side = src.get(b)
            t0 = time.perf_counter()
            log_.add(ex.process_columnar(ts, cols, stream=side))
            call_s.append(time.perf_counter() - t0)
            if b == 1:
                ex.coalesce_rows = 1 << 15
        log_.add(ex.flush_changes())
        torch.cuda.synchronize()
    counts = launch_counts()
    js = dict(ex.join_stats)
    assert ex._dev is not None and ex._dev["sjl"].n_shards == 2
    assert isinstance(ex._inner, ShardedQueryExecutor)
    assert js["probe_batches"] >= 8 and js["fused_batches"] >= 1, js
    assert js["evict_dispatches"] >= 1, js
    assert counts["sharded_join_probe_step"] == js["fused_batches"] == \
        counts["sharded_join_scatter"], (counts, js)
    assert counts["sharded_join_probe_insert"] == js["probe_batches"] - \
        js["fused_batches"], (counts, js)
    assert counts["sharded_join_evict"] == js["evict_dispatches"], \
        (counts, js)
    assert counts["join_probe_step"] == counts["join_evict"] == \
        counts["join_probe_insert"] == 0, counts
    if js["fused_batches"] < js["probe_batches"]:
        log(f"sharded join path: {js['probe_batches'] - js['fused_batches']}"
            f" device batches refused by _fuse_ok (the match-fetch path)")
    check = check_join_changes(
        log_, join_reference(src, P15_JOIN_BATCHES, 10_000, 1000),
        with_sum=False)
    single = SINGLE_CARD.get("join")
    if single is None:        # phase 8 did not run first
        one = _join_executor(join_plan(), JOIN_BATCH, dev)
        slog = ChangeLog(src.keys)
        for b in range(P15_JOIN_BATCHES):
            ts, cols, side = src.get(b)
            slog.add(one.process_columnar(ts, cols, stream=side))
            if b == 1:
                one.coalesce_rows = 1 << 15
        slog.add(one.flush_changes())
        single = slog.final()
    got = log_.final()
    assert all(np.array_equal(g, w) for g, w in zip(got[:3], single[:3])), \
        "15b's finals differ from the single-card executor's"
    device_s = sum(call_s[b] for b in range(P15_JOIN_BATCHES)
                   if b >= P15_JOIN_BATCHES - js["probe_batches"])
    return dict(config="sharded join", launches=counts, join_stats=js,
                check=check, finals_equal_single_card=len(got[0]),
                events_per_sec=js["probe_batches"] * JOIN_BATCH / device_s,
                device_batches_s=device_s, host_batches_s=sum(call_s)
                - device_s, store_cap=ex._dev["cap"],
                match_cap=ex._dev["match_cap"],
                sharded_dispatches=ex.sharded_dispatches,
                stage_s=dict(ex.stage_stats),
                device_plane_bytes=sum(ex.device_plane_bytes().values()))


def _fetch_batches(ex, src, log_, armed, n_batches: int) -> None:
    for b in range(n_batches):
        armed[0] = b == n_batches - 1
        ts, cols, side = src.get(b)
        if b == FETCH_WARM + 1:
            # one batch whose match width the shadow does not size: a
            # buffer of 64 columns a shard overflows, and the drain
            # re-probes wider (probe_only)
            ex._dev["match_cap"] = 64
            other = "r" if side == "l" else "l"
            shadow = ex._dev["shadow"][other]
            shadow.probe = lambda *a: None
            log_.add(ex.process_columnar(ts, cols, stream=side))
            del shadow.probe
        else:
            log_.add(ex.process_columnar(ts, cols, stream=side))
        if b == 1:
            ex.coalesce_rows = 1 << 15
    log_.add(ex.flush_changes())


def sharded_fetch_path(dev, captured) -> dict:
    """15c: phase 8b's query and size (2^16 records over 32,000 keys,
    FETCH_WARM + FETCH_TIMED batches, match buffers fetched four at a
    time) on make_mesh(2, 2): the sharded probe + insert, the buffers in
    the reference's layout decoded by unpack_matches, and one overflow
    provoked (the host shadow's sizing skipped for one batch, the match
    width cut to 64) so the probe-only redispatch runs; every final
    change against numpy."""
    from hstream_tpu_torch.parallel import make_mesh

    src = JoinStream(7, FETCH_BATCH, FETCH_KEYS, with_x=True)
    ex = _join_mesh_executor(join_fetch_plan(), FETCH_BATCH,
                             make_mesh(*P15_JOIN_MESH))
    ex.match_drain_depth = 4
    log_ = ChangeLog(src.keys)
    zero_counts()
    n_batches = FETCH_WARM + FETCH_TIMED
    armed = [False]
    t0 = time.perf_counter()
    with capturing_sharded(captured, armed):
        _fetch_batches(ex, src, log_, armed, n_batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    js = dict(ex.join_stats)
    counts = launch_counts()
    assert ex._dev["sjl"].n_shards == 2, ex._dev
    assert js["fused_batches"] == 0 and js["match_redispatches"] >= 1, js
    assert counts["sharded_join_probe_insert"] == js["probe_dispatches"], \
        (counts, js)
    assert counts["sharded_join_probe_only"] == js["match_redispatches"], \
        (counts, js)
    check = check_join_changes(
        log_, join_reference(src, n_batches, 1000, 10_000), with_sum=True)
    return dict(config="sharded fetch", launches=counts, join_stats=js,
                check=check, events_per_sec=n_batches * FETCH_BATCH / wall,
                wall_s=wall, match_cap=ex._dev["match_cap"])


P15_SRV_VIEW = ("CREATE VIEW sess AS SELECT user, COUNT(*) AS c, "
                "APPROX_QUANTILE(lat, 0.5) AS p50 FROM clicks GROUP BY user, "
                "SESSION (INTERVAL 5 SECOND) GRACE BY INTERVAL 0 SECOND;")


def sharded_session_server_path(dev) -> dict:
    """15d: serve(mesh_shape="2x2") serving a session view (config 4's
    query with COUNT(*)) over P15_SRV_BLOCKS framed blocks of 2^18 records
    (P15_SRV_USERS users, 1 s a block); the view's closed sessions
    against numpy; then the view's snapshot taken on the mesh restored
    onto one card and back onto a mesh, each fed the rest of the stream,
    its rows against numpy."""
    import grpc

    from hstream_tpu_torch.client.producer import (ColumnarProducer,
                                                   encode_batch)
    from hstream_tpu_torch.common import records
    from hstream_tpu_torch.engine.snapshot import (restore_executor,
                                                   snapshot_executor)
    from hstream_tpu_torch.engine.sketches import QuantileConfig
    from hstream_tpu_torch.parallel import make_mesh
    from hstream_tpu_torch.proto import api_pb2 as pb
    from hstream_tpu_torch.proto.rpc import HStreamApiStub
    from hstream_tpu_torch.server.main import serve

    n = SRV_BLOCK
    rng = np.random.default_rng(15)
    users = np.array([f"u{i:06d}" for i in range(P15_SRV_USERS)])
    blocks = []
    for b in range(P15_SRV_BLOCKS + 8):
        # a user is on for 2 s of every 8 (off longer than the 5 s gap):
        # sessions close as the stream moves
        on = np.nonzero((np.arange(P15_SRV_USERS) + b) % 8 < 2)[0]
        u = on[rng.integers(0, len(on), n)]
        ts = BASE_TS + 1000 * b + np.sort(rng.integers(0, 1000, n))
        lat = np.abs(rng.normal(50, 20, n)).astype(np.float32)
        blocks.append((u, ts.astype(np.int64), lat))
    frames = [encode_batch(ts, {"user": users[u], "lat": lat})
              for u, ts, lat in blocks]
    qcfg = QuantileConfig()

    def reference(k: int) -> dict:
        """(user, t0) -> (t1, count, p50 bucket) of the sessions closed by
        the first k blocks."""
        u = np.concatenate([x[0] for x in blocks[:k]]).astype(np.int64)
        t = np.concatenate([x[1] for x in blocks[:k]])
        lat = np.concatenate([x[2] for x in blocks[:k]])
        wm = int(t.max())
        o = np.lexsort((t, u))
        u, t, lat = u[o], t[o], lat[o]
        brk = np.ones(len(u), bool)
        brk[1:] = (u[1:] != u[:-1]) | (t[1:] - t[:-1] > SESS_GAP)
        starts = np.nonzero(brk)[0]
        ends = np.append(starts[1:], len(u)) - 1
        sid = np.cumsum(brk) - 1
        bins, _edge = np_quantile_bins(lat, qcfg)
        srt = np.lexsort((bins, sid))
        cnt = ends - starts + 1
        kk = np.maximum(np.ceil((np.float32(0.5) * cnt.astype(np.float32))
                                .astype(np.float64)).astype(np.int64), 1)
        b50 = bins[srt][starts + kk - 1]
        out = {}
        for i in np.nonzero(t[ends] + 2 * SESS_GAP <= wm)[0]:
            out[(users[u[starts[i]]], int(t[starts[i]]))] = (
                int(t[ends[i]]), int(cnt[i]), int(b50[i]))
        return out

    mids = np_quantile_estimate(np.eye(qcfg.n_bins, dtype=np.int64), 1.0,
                                qcfg)[0]

    def check(rows, k: int, what: str) -> int:
        """The closed sessions among `rows` (t1 + 2 gap at or below the
        watermark of the first k blocks; a peek's open sessions are past
        it) against numpy's."""
        want = reference(k)
        wm = max(int(x[1].max()) for x in blocks[:k])
        got = {(r["user"], int(r["winStart"])): r for r in rows
               if int(r["winEnd"]) + SESS_GAP <= wm}
        assert set(got) == set(want), (what, len(got), len(want))
        for key, (t1, c, b50) in want.items():
            r = got[key]
            assert int(r["winEnd"]) == t1 + SESS_GAP and r["c"] == c, \
                (what, key, r, t1, c)
            assert abs(np.searchsorted(mids, np.float32(r["p50"])) - b50) \
                <= 1, (what, key, r["p50"], b50)
        return len(want)

    server, ctx = serve("127.0.0.1", 0, "mem://", mesh_shape="2x2")
    opts = [("grpc.max_receive_message_length", 64 << 20),
            ("grpc.max_send_message_length", 64 << 20)]
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}", options=opts)
    stub = HStreamApiStub(ch)
    try:
        assert ctx.mesh.shape == {"data": 2, "key": 2}, ctx.mesh
        stub.CreateStream(pb.Stream(stream_name="clicks"))
        stub.ExecuteQuery(pb.CommandQuery(stmt_text=P15_SRV_VIEW))
        task = _srv_task(ctx, "view-sess")
        zero_counts()
        t0 = time.perf_counter()
        resp = ColumnarProducer(ch, "clicks").append_stream_frames(
            iter(frames[:P15_SRV_BLOCKS]))
        assert resp.rows == P15_SRV_BLOCKS * n, resp.rows
        target = int(blocks[P15_SRV_BLOCKS - 1][1].max())
        deadline = time.monotonic() + SRV_DRAIN_S
        while task.executor is None or task.executor.watermark < target:
            assert task.error is None, task.error
            assert time.monotonic() < deadline, "15d: not drained"
            time.sleep(0.002)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ex = task.executor
        assert ex._dev is not None and ex._dev["ssl"].n_shards == 2, \
            ex._device_refusal
        assert task.mesh_shards() == 2 and ex.sharded_dispatches > 0
        step = "sharded_session_" + ("step" if ex._dev["mode"] == "record"
                                     else "merge")
        deadline = time.monotonic() + 60
        while True:
            out = stub.ExecuteQuery(pb.CommandQuery(
                stmt_text="SELECT * FROM sess;"))
            rows = [records.struct_to_dict(s) for s in out.result_set]
            try:
                served = check(rows, P15_SRV_BLOCKS, "the mesh's pull")
                break
            except AssertionError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        counts = launch_counts()
        with task.state_lock:
            ex.drain_closed()
            blob = snapshot_executor(ex)
        rest = blocks[P15_SRV_BLOCKS:]

        def resume(ex2, what):
            rows2 = []
            for u, ts, lat in rest:
                rows2.extend(ex2.process_columnar(
                    ts, {"user": users[u], "lat": lat}))
            rows2.extend(ex2.drain_closed())
            want = reference(P15_SRV_BLOCKS + len(rest))
            done = reference(P15_SRV_BLOCKS)
            new = {k: v for k, v in want.items() if k not in done}
            got = [r for r in rows2 if (r["user"], int(r["winStart"]))
                   in new]
            assert len(got) == len(new), (what, len(got), len(new))
            for r in got:
                t1, c, b50 = new[(r["user"], int(r["winStart"]))]
                assert r["c"] == c and int(r["winEnd"]) == t1 + SESS_GAP, \
                    (what, r)
            return len(got)

        one, _ = restore_executor(task.plan, blob, device=dev)
        assert one.mesh is None
        back, _ = restore_executor(task.plan, snapshot_executor(one),
                                   mesh=make_mesh(*P15_JOIN_MESH))
        n_one = resume(one, "mesh snapshot on one card")
        n_back = resume(back, "one-card snapshot on the mesh")
        assert back._dev is not None and back._dev["ssl"].n_shards == 2
    finally:
        ch.close()
        server.stop(grace=1)
        ctx.shutdown()
    for name in (step, "sharded_session_extract"):
        assert counts[name] > 0, (name, counts)
    assert counts["session_step"] == counts["session_merge"] == 0, counts
    return dict(config="sharded session server", launches=counts,
                events_per_sec=P15_SRV_BLOCKS * n / wall, wall_s=wall,
                sessions_served=served, snapshot_bytes=len(blob),
                resumed_one_card=n_one, resumed_mesh=n_back)


def _valid_records(batch: torch.Tensor, n: int) -> int:
    """The batch's valid records (below the sentinel within n): each is
    probed once, in its own shard's store."""
    return int((batch[0, :n] < JOIN_SENT).sum())


def time_touched_15b(results, args) -> None:
    """B19a's merged changelog extract on 15b's own inputs (the join's
    inner lattice on the (2, 2) mesh, K = 2^19, at its last batch): held
    against its plain version, then timed with its flags refilled before
    each call (the refill left out)."""
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.parallel import lattice as pl

    spec, state, mo = args
    most = merged_touched_vs_plain(spec, state, mo, "at 15b's inputs")
    st = _clone(state)
    saved = [[p["touched"].clone() for p in row] for row in st]

    def refill():
        for row, srow in zip(st, saved):
            for p, s in zip(row, srow):
                p["touched"].copy_(s)

    def again():
        refill()
        return pl.touched_merged(spec, st, mo)

    n_t = int(again()[:, 0, 0].sum())
    call = cuda_time_ms(again, 20) - cuda_time_ms(refill, 20)
    ms = kernel_only_ms(again, 20, ("merged_", "Memset"),
                        expect=P15_EVENTS["touched"])
    src = "profiler" if ms is not None else "events"
    ms = call if ms is None else ms
    plain = kernel_ms(lambda: (refill(), pl.touched_merged_ref(spec, st,
                                                                mo)), 2)[0]
    kinds = lattice.plane_merge_kinds(spec)
    lib = kernel_ms(lambda: stacked_merge(st, kinds, lambda v: v), 5)[0]
    D, nk = st.n_data, st.n_key
    cells = spec.n_keys * spec.n_slots
    per_cell = sum(int(v[0, 0].nbytes) for k, v in st[0][0].items()
                   if k not in ("touched", "slot_start"))
    rows = 3 + lattice.out_rows(spec)
    b_ms, b_by = bound(2 * D * nk * cells + D * n_t * per_cell
                       + nk * rows * mo * 4, 0)
    results["merged_touched_join"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/touched.cu",
        replaces="hstream_tpu/parallel/lattice.py:297",
        paths=("sharded join",), counter="merged_touched", max_abs_err=0.0,
        ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib, call_ms=call,
        ms_source=src, touched=n_t, max_out=mo, mesh=[D, nk],
        local_keys=spec.n_keys,
        library_what="torch.stack + sum/amax of the planes, the merge "
                     "alone")
    log(f"merged_touched at 15b's inputs ((2, 2) mesh, {nk} x {cells} cells, "
        f"{n_t} touched, max_out {mo}, the busiest shard {most}): exact "
        f"against plain; {ms:.4f} ms ({src}; a call {call:.4f}; plain "
        f"{plain:.4f}, torch.stack + sum/amax {lib:.4f}, bound {b_ms:.5f} "
        f"by {b_by}: {ms / b_ms:.2f}x)")


def time_sharded_join(dev, results, captured):
    """Each B19b kernel on 15b's and 15c's own inputs (one call of each,
    kept by the runs: 15b's last fused step, its table scatter and first
    eviction, 15c's last probe + insert and its redispatch), held against
    its plain version on them and timed beside it, with its bound and a
    PyTorch yardstick. The bounds count each valid record's two searches
    once (in its own shard's store), as the table launches do."""
    from hstream_tpu_torch.parallel import lattice as pl

    missing = [k for k in P15_CAPTURED[4:] if k not in captured]
    assert not missing, f"15b and 15c made no call of {missing}"
    time_touched_15b(results, captured["touched_merged"])
    args = captured["sharded_join_probe_insert_step"]
    (mines, others, batch, n, within, cutoff, mc, nm, spec, state, wm_rel,
     ts_off, progs, feed) = args
    total = sharded_fused_vs_plain(args, "sharded_join_probe_step at 15b's "
                                   "shapes")
    outs = [jl_empty(x) for x in mines]
    st = _clone(state)
    ms, call, srcm = kernel_ms(lambda: pl.sharded_join_probe_insert_step(
        mines, others, batch, n, within, cutoff, mc, nm, spec, st, wm_rel,
        ts_off, progs, feed, outs=outs), 10, expect=P15_EVENTS["join step"])
    devt = profiled_calls(lambda: pl.sharded_join_probe_insert_step(
        mines, others, batch, n, within, cutoff, mc, nm, spec, st, wm_rel,
        ts_off, progs, feed, outs=outs), 5, "the sharded fused join",
        P15_EVENTS["join step"])
    stages = None if devt is None else _by_stage(devt, 5)
    plain = kernel_ms(lambda: pl.sharded_join_probe_insert_step_ref(
        mines, others, batch, n, within, cutoff, mc, nm, spec, st, wm_rel,
        ts_off, progs, feed), 1)[0]
    keys = [_query_keys(o, batch, n, within) for o in others]
    lib = kernel_ms(lambda: [torch.searchsorted(sk, qk) for sk, qk in keys],
                    10)[0]
    S, cap = len(mines), mines[0]["code"].shape[0]
    state_bytes = sum(int(v.nbytes) for row in state for p in row
                      for v in p.values())
    nbytes = 2 * sum(_store_bytes(x) for x in mines) + sum(
        _store_bytes(x) for x in others) + int(batch.nbytes) \
        + 2 * state_bytes
    ops = 2 * _valid_records(batch, n) * np.log2(cap) \
        + total * (np.log2(batch.shape[1]) + 1)
    b_ms, b_by = bound(nbytes, ops)
    results["sharded_join_probe_step"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, shards=S, cap=cap, n=n,
        matches=total, match_cap=mc, stages_ms=stages)
    log(f"sharded_join_probe_step at 15b's shapes ({S} shards of {cap} "
        f"slots, {n} records, {total} matches, match_cap {mc} a shard): "
        f"kernels and plain agree; {ms:.4f} ms (plain {plain:.4f}, {S} "
        f"torch.searchsorted {lib:.4f}, bound {b_ms:.4f} by {b_by}; by "
        f"stage {json.dumps(stages)})")
    del outs, st

    (sspec, sstate, parts, swm, kid, sts, valid,
     scols) = captured["scatter_table_cuda"]
    got, want = _clone(sstate), _clone(sstate)
    pl.scatter_table_cuda(sspec, got, parts, swm, kid, sts, valid, scols)
    pl.scatter_table_ref(sspec, want, parts, swm, kid, sts, valid, scols)
    torch.cuda.synchronize()
    for d, k in parts:
        for name, v in want[d][k].items():
            assert torch.equal(got[d][k][name], v), \
                f"scatter_table at 15b's shapes: ({d}, {k}) {name}"
    del got, want
    st = _clone(sstate)
    ms, call, srcm = kernel_ms(lambda: pl.scatter_table_cuda(
        sspec, st, parts, swm, kid, sts, valid, scols), 20,
        expect=P15_EVENTS["scatter"])
    plain = kernel_ms(lambda: pl.scatter_table_ref(
        sspec, st, parts, swm, kid, sts, valid, scols), 2)[0]
    m = kid.shape[0]
    part_bytes = sum(int(v.nbytes) for d, k in parts
                     for v in sstate[d][k].values())
    feed_bytes = int(kid.nbytes + sts.nbytes + valid.nbytes) + sum(
        int(v.nbytes) for v in scols.values())
    b_ms, b_by = bound(feed_bytes + 2 * part_bytes,
                       m * sspec.windows_per_record * (2 + len(sspec.aggs)))
    results["sharded_join_scatter"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, call_ms=call, ms_source=srcm, entries=m,
        partials=len(parts))
    log(f"sharded_join_scatter of 15b's {m}-entry feed into {len(parts)} "
        f"partials (one table): exact against plain; {ms:.4f} ms (plain "
        f"{plain:.4f}, bound {b_ms:.5f} by {b_by})")
    del st

    lefts, rights, e_cutoff, delta = captured["sharded_join_evict"]
    outs = ([jl_empty(x) for x in lefts], [jl_empty(x) for x in rights])
    gl, gr, gn = pl.sharded_join_evict(lefts, rights, e_cutoff, delta,
                                       outs=outs)
    wl, wr, wn = pl.sharded_join_evict_ref(lefts, rights, e_cutoff, delta)
    torch.cuda.synchronize()
    assert torch.equal(gn, wn) and all(
        stores_equal(a, b) for a, b in zip(wl + wr, gl + gr)), \
        "sharded_join_evict at 15b's shapes"
    ms, call, srcm = kernel_ms(lambda: pl.sharded_join_evict(
        lefts, rights, e_cutoff, delta, outs=outs), 10,
        expect=P15_EVENTS["evict"])
    plain = kernel_ms(lambda: pl.sharded_join_evict_ref(
        lefts, rights, e_cutoff, delta), 2)[0]
    skeys = torch.stack([(x["code"].long() << 32) | (x["ts"].long()
                                                     + (1 << 31))
                         for x in lefts + rights])
    lib = kernel_ms(lambda: torch.sort(skeys, dim=1, stable=True), 10)[0]
    ecap = lefts[0]["code"].shape[0]
    b_ms, b_by = bound(2 * sum(_store_bytes(x) for x in lefts + rights),
                       2 * len(lefts) * ecap)
    results["sharded_join_evict"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, shards=len(lefts), cap=ecap,
        live=gn.tolist())
    log(f"sharded_join_evict of 15b's {len(lefts)} x 2 stores of {ecap} "
        f"slots (live {gn.tolist()}): exact against plain; {ms:.4f} ms "
        f"(plain {plain:.4f}, torch.sort of every side's keys {lib:.4f}, "
        f"bound {b_ms:.4f} by {b_by})")
    del outs, gl, gr, wl, wr

    (mines, others, batch, n, within, cutoff, mc,
     nm) = captured["sharded_join_probe_insert"]
    outs = [jl_empty(x) for x in mines]
    got_m, got_p = pl.sharded_join_probe_insert(
        mines, others, batch, n, within, cutoff, mc, nm, outs=outs)
    want_m = pl.sharded_join_insert_ref(mines, batch, n, nm)
    want_p = pl.sharded_join_probe_ref(others, batch, n, within, cutoff,
                                       mc, nm)
    torch.cuda.synchronize()
    assert torch.equal(got_p, want_p) and all(
        stores_equal(a, b) for a, b in zip(got_m, want_m)), \
        "sharded_join_probe_insert at 15c's shapes"
    S = len(mines)
    total = sum(int(want_p[0, s * mc]) for s in range(S))
    ms, call, srcm = kernel_ms(lambda: pl.sharded_join_probe_insert(
        mines, others, batch, n, within, cutoff, mc, nm, outs=outs), 10,
        expect=P15_EVENTS["probe insert"])
    devt = profiled_calls(lambda: pl.sharded_join_probe_insert(
        mines, others, batch, n, within, cutoff, mc, nm, outs=outs), 5,
        "the sharded probe + insert", P15_EVENTS["probe insert"])
    stages = None if devt is None else _by_stage(devt, 5)
    plain = kernel_ms(lambda: (
        pl.sharded_join_insert_ref(mines, batch, n, nm),
        pl.sharded_join_probe_ref(others, batch, n, within, cutoff, mc,
                                  nm)), 2)[0]
    keys = [_query_keys(o, batch, n, within) for o in others]
    lib = kernel_ms(lambda: [torch.searchsorted(sk, qk) for sk, qk in keys],
                    10)[0]
    cap = mines[0]["code"].shape[0]
    nbytes = 2 * sum(_store_bytes(x) for x in mines) + sum(
        _store_bytes(x) for x in others) + int(batch.nbytes) \
        + int(want_p.nbytes)
    b_ms, b_by = bound(nbytes, 2 * _valid_records(batch, n) * np.log2(cap)
                       + total * np.log2(batch.shape[1]))
    results["sharded_join_probe_insert"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, shards=S, cap=cap, n=n, matches=total,
        match_cap=mc, stages_ms=stages)
    log(f"sharded_join_probe_insert at 15c's shapes ({S} shards of {cap} "
        f"slots, {n} records, {total} matches, match_cap {mc} a shard): "
        f"exact against plain; {ms:.4f} ms (plain {plain:.4f}, {S} "
        f"torch.searchsorted {lib:.4f}, bound {b_ms:.4f} by {b_by}; by "
        f"stage {json.dumps(stages)})")
    others, batch, n, within, cutoff, mc, nm = \
        captured["sharded_join_probe_only"]
    got = pl.sharded_join_probe_only(others, batch, n, within, cutoff, mc,
                                     nm)
    want = pl.sharded_join_probe_ref(others, batch, n, within, cutoff, mc,
                                     nm)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "sharded_join_probe_only at 15c's shapes"
    ms, call, srcm = kernel_ms(lambda: pl.sharded_join_probe_only(
        others, batch, n, within, cutoff, mc, nm), 10,
        expect=P15_EVENTS["probe only"])
    plain = kernel_ms(lambda: pl.sharded_join_probe_ref(
        others, batch, n, within, cutoff, mc, nm), 2)[0]
    total = sum(int(want[0, s * mc]) for s in range(S))
    b_ms, b_by = bound(sum(_store_bytes(x) for x in others)
                       + int(batch.nbytes) + int(want.nbytes),
                       2 * _valid_records(batch, n)
                       * np.log2(others[0]["code"].shape[0])
                       + total * np.log2(batch.shape[1]))
    results["sharded_join_probe_only"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, shards=S, n=n, matches=total,
        match_cap=mc)
    log(f"sharded_join_probe_only of 15c's redispatch ({total} matches, "
        f"match_cap {mc} a shard): exact against plain; {ms:.4f} ms (plain "
        f"{plain:.4f}, bound {b_ms:.4f} by {b_by})")


# ---- phase 16: the replicated server, failed over -----------------------------
#
# HStreamDB's durable stream: replication factor 3 over three nodes (the
# LogDevice-backed --replicate-factor of upstream hstream/app/server.hs,
# which hstream_tpu/server/main.py:195-199 cites). Two followers
# (store/replica.py serve_follower) over file:// stores of their own and
# the leader serve(replicate=..., replication_factor=3) on the card; the
# headline view and config 1's stream as phase 13 sends it, a block a
# call; a JSON block and a pull through the HTTP gateway; a sqlite sink
# connector on the stream of the view's rows; `admin replicas` and
# `admin status`; then the leader stops, the most caught-up follower is
# promoted (promote_best, as `admin promote replicas=` does), a server
# boots over its store (serve(store=...)) with the other follower and
# the old leader's store as its followers, restores the view's snapshot
# on the card and ingests the rest.

P16_BLOCKS = 10              # framed blocks of 2^18 before the failover,
                             # and again after: window 0 whole
P16_ROWS = ("CREATE STREAM headline_rows AS SELECT device, COUNT(*) AS cnt, "
            "SUM(temp) AS total, APPROX_COUNT_DISTINCT(temp) AS uniq "
            "FROM sensors GROUP BY device, TUMBLING (INTERVAL 10 SECOND) "
            "GRACE BY INTERVAL 0 SECOND;")
P16_SINK = "headline_sink"
_CLOSER_GAP = 20_000         # ms from the last block to the closer


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def replica_logs(store) -> dict:
    """{logid: [(lsn, sha256 of the batch's payloads)]} of every data log
    of a store (the replication op-log left out): what a replica holds of
    every acknowledged append."""
    import hashlib

    from hstream_tpu_torch.store.api import DataBatch
    from hstream_tpu_torch.store.replica import OPLOG_ID

    out = {}
    for logid in sorted(store.list_logs()):
        if logid == OPLOG_ID:
            continue
        tail = store.tail_lsn(logid)
        rows = []
        if tail:
            reader = store.new_reader()
            reader.set_timeout(0)
            reader.start_reading(logid, 1, tail)
            while True:
                got = reader.read(256)
                if not got:
                    break
                rows += [(b.lsn, hashlib.sha256(b"".join(
                    len(p).to_bytes(8, "little") + bytes(p)
                    for p in b.payloads)).hexdigest())
                    for b in got if isinstance(b, DataBatch)]
            reader.stop_reading(logid)
        out[logid] = rows
    return out


def same_replicas(stores: dict, what: str) -> int:
    """Every store holds the same data logs, batch for batch at the same
    LSNs with the same bytes. Returns the batches."""
    logs = {name: replica_logs(st) for name, st in stores.items()}
    first = next(iter(logs))
    for name, got in logs.items():
        assert got == logs[first], f"{what}: replica {name} differs " \
            f"from {first}"
    return sum(len(v) for v in logs[first].values())


def _cli(main, port: int, *argv) -> str:
    """The port's admin CLI against a server: its printed text."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--port", str(port), *argv])
    assert rc == 0, (argv, out.getvalue())
    return out.getvalue()


def _sink_rows(path) -> list:
    import sqlite3

    conn = sqlite3.connect(path)
    try:
        return conn.execute("SELECT device, cnt, total, uniq, winStart "
                            "FROM t ORDER BY winStart, device").fetchall()
    finally:
        conn.close()


def _closer(src, b: int) -> bytes:
    """One record a window past block b's: it closes every window
    before it."""
    from hstream_tpu_torch.client.producer import encode_batch

    ts = src.last_ts(b) + _CLOSER_GAP
    return encode_batch(np.array([ts], np.int64),
                        {"device": SRV_DEVS[:1],
                         "temp": np.array([20.0], np.float32)})


def replicated_path(dev) -> dict:
    """Phase 16 (above): acked appends on all three replicas at the same
    LSNs with the same bytes, no degraded ack, the view's rows over the
    whole stream equal numpy's across the failover, the sink's rows the
    view's; ack latency a block, events/s and the failover's seconds."""
    import tempfile
    import urllib.request

    import grpc

    from hstream_tpu_torch.admin import main as admin_main
    from hstream_tpu_torch.client.producer import ColumnarProducer
    from hstream_tpu_torch.common import records
    from hstream_tpu_torch.http_gateway import serve_gateway
    from hstream_tpu_torch.proto import api_pb2 as pb
    from hstream_tpu_torch.proto.rpc import HStreamApiStub
    from hstream_tpu_torch.server.main import serve
    from hstream_tpu_torch.store import open_store
    from hstream_tpu_torch.store import replica

    src = ServerStream(seed=16)
    n = 2 * P16_BLOCKS
    frames = [src.frame(b) for b in range(n)]
    opts = [("grpc.max_receive_message_length", 64 << 20),
            ("grpc.max_send_message_length", 64 << 20)]
    out: dict = {"config": "replicated"}
    acks: list = []
    ingest_s = [0.0]

    def feed(stub_ch, tasks, lo, hi):
        producer = ColumnarProducer(stub_ch, "sensors")
        t0 = time.perf_counter()
        for b in range(lo, hi):
            t = time.perf_counter()
            resp = producer.append_stream_frames(iter([frames[b]]))
            acks.append((time.perf_counter() - t) * 1e3)
            assert resp.rows == SRV_BLOCK, resp.rows
        _srv_drained(tasks, src.last_ts(hi - 1))
        ingest_s[0] += time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        fstores = {name: open_store(f"file://{d}/{name}")
                   for name in ("f1", "f2")}
        faddr = {name: f"127.0.0.1:{_free_port()}" for name in fstores}
        followers = {name: replica.serve_follower(
            st, faddr[name], node_id=name) for name, st in fstores.items()}
        sink_db = os.path.join(d, "sink.db")
        import sqlite3

        conn = sqlite3.connect(sink_db)
        conn.execute("CREATE TABLE t (device TEXT, cnt INTEGER, total REAL, "
                     "uniq INTEGER, winStart INTEGER, winEnd INTEGER)")
        conn.commit()
        conn.close()
        server, ctx = serve("127.0.0.1", 0, f"file://{d}/leader",
                            replicate=",".join(faddr.values()),
                            replication_factor=3)
        ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}", options=opts)
        stub = HStreamApiStub(ch)
        httpd = gw = None
        stopped = False
        try:
            assert ctx.device == dev, ctx.device
            assert isinstance(ctx.store, replica.ReplicatedStore)
            stub.CreateStream(pb.Stream(stream_name="sensors",
                                        replication_factor=3))
            stub.ExecuteQuery(pb.CommandQuery(stmt_text=SRV_VIEW))
            stub.ExecuteQuery(pb.CommandQuery(stmt_text=P16_ROWS))
            rows_qid = next(q.id for q in stub.ListQueries(
                pb.ListQueriesRequest()).queries
                if "headline_rows" in q.query_text)
            stub.ExecuteQuery(pb.CommandQuery(
                stmt_text=f"CREATE SINK CONNECTOR {P16_SINK} WITH (type = "
                          f"'sqlite', stream = 'headline_rows', path = "
                          f"'{sink_db}', table = 't');"))
            tasks = [_srv_task(ctx, "view-headline"),
                     _srv_task(ctx, rows_qid)]
            zero_counts()
            feed(ch, tasks, 0, P16_BLOCKS)
            assert all(t.executor.device == dev for t in tasks)
            # the HTTP gateway: a JSON block and a pull of the view
            httpd, gw = serve_gateway(f"127.0.0.1:{ctx.port}", port=0)
            base = f"http://127.0.0.1:{httpd.server_port}"

            def http(method, path, body=None):
                data = json.dumps(body).encode() if body is not None \
                    else None
                req = urllib.request.Request(base + path, data=data,
                                             method=method)
                if data:
                    req.add_header("Content-Type", "application/json")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, json.loads(resp.read())

            assert http("POST", "/streams", {"name": "probe"})[0] == 201
            code, got = http("POST", "/streams/probe/append", {"records": [
                {"device": f"p{i}", "temp": 20.5 + i,
                 "__time_ms": BASE_TS + i} for i in range(16)]})
            assert code == 200 and len(got["record_ids"]) == 16, got
            code, gw_rows = http("GET", "/views/headline")
            grpc_rows = _srv_pull(stub, pb, records)

            def key(r):
                return (r["winStart"], r["device"])

            assert code == 200 and sorted(gw_rows, key=key) == \
                sorted(grpc_rows, key=key), "gateway pull differs"
            check_pull(grpc_rows, src, dev, P16_BLOCKS, "the leader's pull")
            replicas_text = _cli(admin_main, ctx.port, "replicas")
            status_text = _cli(admin_main, ctx.port, "status")
            fol = ctx.store.follower_status()
            assert all(f["alive"] and f["behind"] == 0 for f in fol), fol
            assert ctx.store.degraded_appends == 0 and \
                ctx.store.last_ack_status == "replicated", \
                (ctx.store.degraded_appends, ctx.store.last_ack_status)
            out["leader_oplog_seq"] = ctx.store.oplog_seq
            counts_a = launch_counts()
        finally:
            if httpd is not None:
                httpd.shutdown()
                gw.close()
            ch.close()
            server.stop(grace=1)
            ctx.shutdown()   # detaches the tasks: their final snapshots
            stopped = True
        assert stopped
        assert "leader-status" in replicas_text and \
            replicas_text.count("| leader ") == 2, replicas_text
        assert "Running" in status_text, status_text
        # the old leader's store, closed with its server: every acked
        # append on the three replicas
        old = open_store(f"file://{d}/leader")
        out["batches_at_failover"] = same_replicas(
            {"leader": old, **fstores}, "at the failover")
        # failover: promote the most caught-up follower (admin promote
        # replicas=), boot a server over its store, the other follower
        # and the old leader's store its followers
        new_port = _free_port()
        t_fail = time.perf_counter()
        res = replica.promote_best(list(faddr.values()),
                                   leader_addr=f"127.0.0.1:{new_port}",
                                   promoted_by="chip_smoke")
        assert res["ok"] and res["epoch"] == 1 and not res["unreachable"], \
            res
        name = next(k for k, a in faddr.items() if a == res["target"])
        other = next(k for k in faddr if k != name)
        srv_p, svc_p = followers.pop(name)
        srv_p.stop(grace=1).wait(10)
        svc_p.close()
        old_addr = f"127.0.0.1:{_free_port()}"
        followers["old"] = replica.serve_follower(old, old_addr,
                                                  node_id="old-leader")
        server2, ctx2 = serve("127.0.0.1", new_port, store=fstores[name],
                              replicate=f"{faddr[other]},{old_addr}",
                              replication_factor=3)
        ch2 = grpc.insecure_channel(f"127.0.0.1:{new_port}", options=opts)
        stub2 = HStreamApiStub(ch2)
        try:
            assert ctx2.store.epoch == 1, ctx2.store.epoch
            tasks2 = [_srv_task(ctx2, "view-headline"),
                      _srv_task(ctx2, rows_qid)]
            for t in tasks2:   # resumed from their snapshots, on the card
                assert t.executor is not None and \
                    t.executor.device == dev, t.executor
            first = check_pull(_srv_pull(stub2, pb, records), src, dev,
                               P16_BLOCKS, "the promoted server's pull")
            out["failover_s"] = time.perf_counter() - t_fail
            stub2.RestartConnector(pb.RestartConnectorRequest(id=P16_SINK))
            feed(ch2, tasks2, P16_BLOCKS, n)
            ColumnarProducer(ch2, "sensors").append_stream_frames(
                iter([_closer(src, n - 1)]))
            _srv_drained(tasks2, _CLOSER_GAP + src.last_ts(n - 1))
            view = _srv_pull(stub2, pb, records)
            closed = [r for r in view if _window_of(r["winStart"]) == 0]
            check_server_window(closed, src.window(0, n), dev,
                                "the view's window 0 across the failover")
            tail = [r for r in view if _window_of(r["winStart"]) > 0]
            assert [(r["device"], r["cnt"]) for r in tail] == \
                [(SRV_DEVS[0], 1)], tail
            sink = poll_sink(sink_db, N_KEYS)
            by_dev = {r["device"]: r for r in closed}
            for dv, cnt, total, uniq, ws in sink:
                r = by_dev[dv]
                assert (cnt, uniq, ws) == (r["cnt"], r["uniq"],
                                           r["winStart"]), (dv, r)
            check_server_window([dict(device=s[0], cnt=s[1], total=s[2],
                                      uniq=s[3]) for s in sink],
                                src.window(0, n), dev, "the sink's rows")
            assert ctx2.store.degraded_appends == 0 and \
                ctx2.store.last_ack_status == "replicated", \
                (ctx2.store.degraded_appends, ctx2.store.last_ack_status)
            fol = poll_caught_up(ctx2.store)
            counts_b = launch_counts()
        finally:
            ch2.close()
            server2.stop(grace=1)
            ctx2.shutdown()
        for srv, svc in followers.values():
            srv.stop(grace=1)
            svc.close()
        promoted = open_store(f"file://{d}/{name}")
        out["batches_at_end"] = same_replicas(
            {"promoted": promoted, other: fstores[other], "old leader": old},
            "at the end")
        for st in (promoted, fstores[other], old):
            st.close()
    # B1a, B1c and B3 on both servers, B2 at the closer
    for k in ("wire_decode", "scatter_aggregate", "extract_close"):
        assert counts_b[k] > counts_a[k] > 0, (k, counts_a, counts_b)
    assert counts_b["fused_close"] > 0, counts_b
    ack = np.asarray(acks)
    out.update(launches=counts_b, blocks=n, events=n * SRV_BLOCK,
               events_per_sec=n * SRV_BLOCK / ingest_s[0],
               ack_ms=acks, ack_ms_p50=float(np.percentile(ack, 50)),
               ack_ms_p99=float(np.percentile(ack, 99)),
               promoted=res, followers_after=fol, sink_rows=len(sink),
               first_pull_windows=sorted(first.items()))
    return out


# ---- phase 17: packed push queries and placer adoption on the card ----------
#
# The cluster layer (hstream_tpu_torch/placer). 17a: serve(pack_queries=True)
# on the card, three push queries of one signature at config 1's width
# (bench.py:60-119: 1000 devices, one-decimal temps; COUNT, SUM and
# APPROX_COUNT_DISTINCT) sharing one pack group's executor, and a fourth
# that packing refuses (a WHERE) as a standalone task; framed blocks a
# call, one member terminated mid-stream; then the same three queries
# unpacked on a server of their own, a diagnostic. 17b: three armed nodes
# over one shared store (tests/test_chaos.py's placer cluster), one push
# query placed by the placer, its owner killed crash-style mid-stream, a
# survivor adopting it and resuming from its snapshot on the card.

P17_BLOCK = 1 << 16          # records a block (phase 13 sends 2^18): the
                             # pack runner makes three row dicts a record
P17_MS = 1000                # stream ms a block
P17_WARM = 4                 # blocks member 1 ingests alone
P17_BLOCKS = 24              # blocks before the termination: windows 0-2
P17_AFTER = 4                # blocks after it, in window 3
P17_CAP = 4096               # the pack group's batch_capacity (packing.py)
P17_WARM_KEYS = 3200         # other devices in member 1's warm-up: the
                             # group's key span reaches its 8192 rung
                             # before members 2 and 3 add 2000 keys, as
                             # tests/test_packing.py warms its span
P17_KEYS = N_KEYS + P17_WARM_KEYS
P17_DEVS = np.array([f"d{k}" for k in range(P17_KEYS)])
P17_LEASE_MS = 2000          # 17b's heartbeat lease (ROADMAP C)
P17B_BLOCKS = 12             # 17b's blocks: windows 0 and 1
P17B_KILL_AT = 6             # ... the owner is killed after this many
P17_SELECT = ("SELECT device, COUNT(*) AS c{i}, SUM(temp) AS s{i}, "
              "APPROX_COUNT_DISTINCT(temp) AS d{i} FROM sensors{where} "
              "GROUP BY device, TUMBLING (INTERVAL 10 SECOND) "
              "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
P17_WHERE = " WHERE temp > 15.0"


def p17_query(i, where: str = "") -> str:
    return f"CREATE STREAM pk{i} AS " + P17_SELECT.format(i=i, where=where)


class PackStream:
    """Config 1's stream in framed blocks of P17_BLOCK records, P17_MS of
    stream a block from a given start, N_UNIQUE pre-made (keys, temps)
    pairs cycled, one-record closers (d0, 20.0) and a warm-up block of
    P17_WARM_KEYS other devices, one record each, in the second after its
    start. An item is ("block", pair, start ms), ("closer", 0, ms) or
    ("warm", 0, ms), ms from BASE_TS."""

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        self.kids = [rng.integers(0, N_KEYS, P17_BLOCK).astype(np.int32)
                     for _ in range(N_UNIQUE)]
        self.temps = [(np.rint(rng.normal(20.0, 5.0, P17_BLOCK) * 10)
                       .astype(np.float32) * np.float32(0.1))
                      for _ in range(N_UNIQUE)]
        self.ts_template = (np.arange(P17_BLOCK, dtype=np.int64)
                            * P17_MS) // P17_BLOCK
        self.warm_temps = (np.rint(rng.normal(20.0, 5.0, P17_WARM_KEYS)
                                   * 10).astype(np.float32)
                           * np.float32(0.1))
        self._aggs: dict = {}

    @staticmethod
    def warm(ms: int) -> tuple:
        return ("warm", 0, ms)

    @staticmethod
    def block(b: int, start_ms: int) -> tuple:
        return ("block", b % N_UNIQUE, start_ms)

    @staticmethod
    def closer(ms: int) -> tuple:
        return ("closer", 0, ms)

    def columns(self, item):
        kind, j, ms = item
        if kind == "closer":
            return (np.array([BASE_TS + ms], np.int64),
                    np.zeros(1, np.int32), np.array([20.0], np.float32))
        if kind == "warm":
            n = P17_WARM_KEYS
            return (BASE_TS + ms + np.arange(n, dtype=np.int64) * P17_MS // n,
                    N_KEYS + np.arange(n, dtype=np.int32), self.warm_temps)
        return BASE_TS + ms + self.ts_template, self.kids[j], self.temps[j]

    def frame(self, item) -> bytes:
        from hstream_tpu_torch.client.producer import encode_batch

        ts, k, v = self.columns(item)
        return encode_batch(ts, {"device": P17_DEVS[k], "temp": v})

    def last_ts(self, item) -> int:
        return int(self.columns(item)[0][-1])

    def aggregates(self, item, where: bool) -> dict:
        """One item's count, SUM, SUM|x| and HLL registers by key."""
        key = (item[0], item[1], where)
        if key not in self._aggs:
            _ts, k, t = self.columns(item)
            if where:
                keep = t > np.float32(15.0)
                k, t = k[keep], t[keep]
            t64 = t.astype(np.float64)
            regs = np.zeros(P17_KEYS * 1024, np.int8)
            reg, rank = np_hll_indices(t)
            np.maximum.at(regs, k.astype(np.int64) * 1024 + reg,
                          rank.astype(np.int8))
            self._aggs[key] = dict(
                count=np.bincount(k, minlength=P17_KEYS),
                sum=np.bincount(k, weights=t64, minlength=P17_KEYS),
                abs=np.bincount(k, weights=np.abs(t64), minlength=P17_KEYS),
                regs=regs.reshape(P17_KEYS, 1024))
        return self._aggs[key]

    def reference(self, items, where: bool = False) -> dict:
        """window -> the aggregates of `items` in it."""
        out: dict = {}
        for it in items:
            a = self.aggregates(it, where)
            w = it[2] // 10_000
            o = out.get(w)
            if o is None:
                out[w] = {k: v.copy() for k, v in a.items()}
                continue
            for k in ("count", "sum", "abs"):
                o[k] = o[k] + a[k]
            o["regs"] = np.maximum(o["regs"], a["regs"])
        return out


def check_member(finals: dict, ref: dict, dev, what: str, i) -> int:
    """A push query's last change of every (device, window) against numpy
    (check_server_window a window)."""
    by_win: dict[int, list] = {}
    for (_d, ws), r in finals.items():
        by_win.setdefault(_window_of(ws), []).append(r)
    want = sorted(w for w, a in ref.items() if a["count"].any())
    assert sorted(by_win) == want, (what, sorted(by_win), want)
    for w, rows in by_win.items():
        check_server_window(rows, ref[w], dev, f"{what} window {w}",
                            cnt=f"c{i}", total=f"s{i}", uniq=f"d{i}")
    return len(finals)


def member_finals(ctx, stream: str, ref: dict, i) -> dict:
    """The sink stream's last changes once their counts add up to the
    reference's records (the sink is written behind the step)."""
    want = int(sum(a["count"].sum() for a in ref.values()))
    deadline = time.monotonic() + SRV_DRAIN_S
    pause = threading.Event()
    while True:
        finals = _push_finals(ctx, stream, temp=False)
        got = sum(r[f"c{i}"] for r in finals.values())
        if got == want:
            return finals
        assert time.monotonic() < deadline, \
            f"{stream}: {got} of {want} records in its last changes"
        pause.wait(0.05)


def append_retrying(producer, frame: bytes):
    """One framed block, sent again after the server's retry_after_ms
    while flow control sheds it (the producer's side of back-pressure)."""
    import re

    import grpc

    deadline = time.monotonic() + SRV_DRAIN_S
    while True:
        try:
            return producer.append_stream_frames(iter([frame]))
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.RESOURCE_EXHAUSTED or \
                    time.monotonic() > deadline:
                raise
            m = re.search(r"retry_after_ms=(\d+)", e.details() or "")
            time.sleep(int(m.group(1)) / 1e3 if m else 0.1)


def _query_ids(stub, pb) -> dict:
    """sink stream -> query id, of every query on the server."""
    out = {}
    for q in stub.ListQueries(pb.ListQueriesRequest()).queries:
        out[q.query_text.split()[2]] = q.id
    return out


def packed_path(dev) -> tuple[dict, dict]:
    """Phase 17a (above): the pack group's one executor on the card, its
    launches a feed, RetraceGuard over the later members, every member's
    and the refused query's last changes against numpy; then the three
    queries unpacked (a diagnostic)."""
    import grpc

    from hstream_tpu_torch.client.producer import ColumnarProducer
    from hstream_tpu_torch.common import records
    from hstream_tpu_torch.common.tracing import RetraceGuard
    from hstream_tpu_torch.placer.packing import PackMemberTask
    from hstream_tpu_torch.proto import api_pb2 as pb
    from hstream_tpu_torch.proto.rpc import HStreamApiStub
    from hstream_tpu_torch.server.main import serve
    from hstream_tpu_torch.server.tasks import QueryTask

    src = PackStream(seed=17)
    pre = [src.block(b, b * P17_MS) for b in range(P17_BLOCKS)]
    c1 = src.closer(30_000)             # closes windows 0-2
    post = [src.block(b, 30_000 + (b - P17_BLOCKS) * P17_MS)
            for b in range(P17_BLOCKS, P17_BLOCKS + P17_AFTER)]
    c2 = src.closer(40_000)             # closes window 3
    # the warm-up block after block 0: a standalone task sizes its batch
    # to the first block it reads (server/tasks.py)
    every = pre[:1] + [src.warm(0)] + pre[1:] + [c1] + post + [c2]
    frames = {it: src.frame(it) for it in every}
    opts = [("grpc.max_receive_message_length", 64 << 20),
            ("grpc.max_send_message_length", 64 << 20)]
    steps = ("wire_decode", "scatter_aggregate", "touched_extract",
             "reset_close")

    def send(producer, items):
        for it in items:
            resp = append_retrying(producer, frames[it])
            assert resp.rows == len(src.columns(it)[0]), resp.rows

    out = {"config": "packed"}
    server, ctx = serve("127.0.0.1", 0, "mem://", pack_queries=True)
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}", options=opts)
    stub = HStreamApiStub(ch)
    try:
        assert ctx.device == dev, ctx.device
        stub.CreateStream(pb.Stream(stream_name="sensors"))
        zero_counts()
        stub.ExecuteQuery(pb.CommandQuery(stmt_text=p17_query(0)))
        q0 = _query_ids(stub, pb)["pk0"]
        g = ctx.pack_pool.member_of(q0)
        assert g is not None, "the first query was not packed"
        feeds: list[dict] = []
        errors: list = []
        shared = [False]   # True once another task steps beside the group
        fed = g.feed

        def counted_feed(rows, ts_ms, lsn=None):
            m = sum(1 for x in list(g.members.values())
                    if lsn is None or lsn > x.attach_lsn)
            exclusive = not shared[0]
            before = launch_counts()
            try:
                fed(rows, ts_ms, lsn=lsn)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
                raise
            after = launch_counts()
            feeds.append(dict(n=len(rows), members=m, ts=max(ts_ms),
                              exclusive=exclusive and not shared[0],
                              launches={k: after[k] - before[k]
                                        for k in steps}))

        g.feed = counted_feed

        def wait_fed(item):
            target = src.last_ts(item)
            deadline = time.monotonic() + SRV_DRAIN_S
            pause = threading.Event()
            while not (feeds and feeds[-1]["ts"] >= target):
                assert not errors, errors
                assert time.monotonic() < deadline, \
                    f"the pack group was not fed to {target}"
                pause.wait(0.002)

        producer = ColumnarProducer(ch, "sensors")
        stage = {}
        t0 = time.perf_counter()
        send(producer, every[:1 + P17_WARM])
        wait_fed(pre[P17_WARM - 1])
        stage["warm"] = time.perf_counter() - t0
        with RetraceGuard() as guard:
            for i in (1, 2):
                stub.ExecuteQuery(pb.CommandQuery(stmt_text=p17_query(i)))
            t0 = time.perf_counter()
            send(producer, pre[P17_WARM:])
            wait_fed(pre[-1])
            torch.cuda.synchronize()
            pack_wall = time.perf_counter() - t0
            send(producer, [c1])
            wait_fed(c1)
        assert guard.count == 0, \
            f"members 2 and 3 compiled {guard.count} programs"
        ids = _query_ids(stub, pb)
        members = [ids[f"pk{i}"] for i in range(3)]
        # the refused query: a standalone task that reads the stream from
        # its start beside the group from here on
        shared[0] = True
        t0 = time.perf_counter()
        text = stub.ExecuteQuery(pb.CommandQuery(
            stmt_text="EXPLAIN " + P17_SELECT.format(i="f", where=P17_WHERE)))
        explain = records.struct_to_dict(text.result_set[0])["explain"]
        assert "PACK: unpackable — filter:" in explain, explain
        stub.ExecuteQuery(pb.CommandQuery(stmt_text=p17_query("f",
                                                              P17_WHERE)))
        qf = _query_ids(stub, pb)["pkf"]
        tf = _srv_task(ctx, qf)
        assert isinstance(tf, QueryTask) and not getattr(tf, "packed", False)
        _srv_drained([tf], src.last_ts(c1))
        stage["refused backlog"] = time.perf_counter() - t0
        packs = ctx.pack_pool.status()
        assert len(packs) == 1 and packs[0]["members"] == sorted(members), \
            packs
        admin = json.loads(stub.SendAdminCommand(pb.AdminCommandRequest(
            command="placer", args=records.dict_to_struct({}))).result)
        assert [sorted(p["members"]) for p in admin["packs"]] == \
            [sorted(members)], admin["packs"]
        assert all(isinstance(ctx.running_queries[q], PackMemberTask)
                   for q in members)
        stub.TerminateQueries(pb.TerminateQueriesRequest(
            query_ids=[members[1]]))
        poll_until(lambda: ctx.pack_pool.status()[0]["members"]
             == sorted([members[0], members[2]]), "the termination")
        t0 = time.perf_counter()
        send(producer, post + [c2])
        wait_fed(c2)
        _srv_drained([tf], src.last_ts(c2))
        stage["after the termination"] = time.perf_counter() - t0
        counts = launch_counts()
        ex = g.executor
        assert ex.device == dev and all(
            t.device == dev for t in ex.state.values()), "a plane left the card"
        assert ex.device_fallbacks == 0 and tf.executor.device == dev
        assert tf.engine_total("device_fallbacks") == 0
        # each feed: one executor's chunks over the tagged rows
        checked = [f for f in feeds if f["exclusive"]]
        for f in checked:
            want = -(-f["members"] * f["n"] // P17_CAP)
            assert f["launches"]["wire_decode"] == want and \
                f["launches"]["scatter_aggregate"] == want, (f, want)
        three = [f for f in checked if f["members"] == 3
                 and f["n"] == P17_BLOCK]
        assert three, "no feed of a whole block to three members"
        for name in steps + ("expression",):
            assert counts[name] > 0, (name, counts)
        t0 = time.perf_counter()
        refs = {0: every, 1: pre[P17_WARM:] + [c1],
                2: pre[P17_WARM:] + [c1] + post + [c2]}
        rows = {}
        for i, items in refs.items():
            ref = src.reference(items)
            rows[f"pk{i}"] = check_member(
                member_finals(ctx, f"pk{i}", ref, i), ref, dev,
                f"packed member pk{i}", i)
        ref = src.reference(every, where=True)
        rows["pkf"] = check_member(member_finals(ctx, "pkf", ref, "f"), ref,
                                   dev, "the refused query", "f")
        pk0_finals = _push_finals(ctx, "pk0", temp=False)
        stage["checks"] = time.perf_counter() - t0
        stage["packed segment"] = pack_wall
        out.update(stage_s=stage, 
            launches=counts, rows=rows, explain_pack=explain.splitlines()[-1],
            feeds=len(feeds), feeds_checked=len(checked),
            step_launches_three_members=three[0]["launches"],
            events_per_sec=(P17_BLOCKS - P17_WARM) * P17_BLOCK / pack_wall,
            group=g.status())
    finally:
        ch.close()
        server.stop(grace=1)
        ctx.shutdown()

    # the same three queries unpacked, over the same blocks (a diagnostic)
    un = {"config": "unpacked"}
    t_un = time.perf_counter()
    server, ctx = serve("127.0.0.1", 0, "mem://")
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}", options=opts)
    stub = HStreamApiStub(ch)
    try:
        stub.CreateStream(pb.Stream(stream_name="sensors"))
        zero_counts()
        for i in range(3):
            stub.ExecuteQuery(pb.CommandQuery(stmt_text=p17_query(i)))
        ids = _query_ids(stub, pb)
        tasks = [_srv_task(ctx, ids[f"pk{i}"]) for i in range(3)]
        producer = ColumnarProducer(ch, "sensors")
        send(producer, every[:1 + P17_WARM])
        _srv_drained(tasks, src.last_ts(pre[P17_WARM - 1]))
        t0 = time.perf_counter()
        send(producer, pre[P17_WARM:])
        _srv_drained(tasks, src.last_ts(pre[-1]))
        wall = time.perf_counter() - t0
        send(producer, [c1] + post + [c2])
        _srv_drained(tasks, src.last_ts(c2))
        un["launches"] = launch_counts()
        ref = src.reference(every)
        equal = {}
        for i in range(3):
            try:
                check_member(member_finals(ctx, f"pk{i}", ref, i), ref, dev,
                             f"unpacked pk{i}", i)
                equal[f"pk{i}"] = True
            except AssertionError as e:
                equal[f"pk{i}"] = str(e)[:200]
        got = _push_finals(ctx, "pk0", temp=False)
        equal["pk0 packed"] = all(
            got.get(k, {}).get("c0") == r["c0"]
            and got.get(k, {}).get("d0") == r["d0"]
            for k, r in pk0_finals.items()) and len(got) == len(pk0_finals)
        un.update(rows_equal=equal, wall_s=time.perf_counter() - t_un,
                  events_per_sec=(P17_BLOCKS - P17_WARM) * P17_BLOCK / wall,
                  scatter_launches_a_block=un["launches"]["scatter_aggregate"]
                  / len(every))
    finally:
        ch.close()
        server.stop(grace=1)
        ctx.shutdown()
    return out, un


def poll_until(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    pause = threading.Event()
    while not cond():
        assert time.monotonic() < deadline, f"{what}: not within {timeout} s"
        pause.wait(0.02)


def _node_kill(server, ctx) -> None:
    """Crash-style death (tests/test_chaos.py:1428): no record cleanup,
    the node's scheduler records just stop heartbeating."""
    ctx.placer.stop()
    ctx.supervisor.shutdown()
    server.stop(grace=0)
    for task in list(ctx.running_queries.values()):
        with contextlib.suppress(Exception):
            task.stop(detach=True)
    ctx.running_queries.clear()
    ctx.load_reporter.stop()


def placer_path(dev) -> dict:
    """Phase 17b (above): exactly one survivor adopts, no two owners at
    any sampled instant, the adopter restores the snapshot on the card,
    and the sink's last changes equal numpy."""
    import grpc

    from hstream_tpu_torch.client.producer import ColumnarProducer
    from hstream_tpu_torch.proto import api_pb2 as pb
    from hstream_tpu_torch.proto.rpc import HStreamApiStub
    from hstream_tpu_torch.server.main import serve
    from hstream_tpu_torch.store import open_store
    from hstream_tpu_torch.store.api import LSN_MIN

    src = PackStream(seed=171)
    items = [src.block(b, b * P17_MS) for b in range(P17B_BLOCKS)]
    items.append(src.closer(20_000))    # closes window 1
    frames = [src.frame(it) for it in items]
    store = open_store("mem://")
    nodes, ticks, channels = [], {}, []
    dead: set[int] = set()
    out = {"config": "placer"}
    try:
        for i in range(3):
            server, ctx = serve(
                "127.0.0.1", 0, store=store, owns_store=False,
                placer_interval_ms=100, heartbeat_lease_ms=P17_LEASE_MS,
                snapshot_interval_ms=60, load_report_interval_ms=300)
            nodes.append((server, ctx))
            ticks[i] = []
            tick = ctx.placer.tick

            def timed(tick=tick, i=i):
                t0 = time.perf_counter()
                tick()
                ticks[i].append(time.perf_counter() - t0)

            ctx.placer.tick = timed
            assert ctx.device == dev, ctx.device

        def stub_of(ctx):
            ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
            channels.append(ch)
            return ch, HStreamApiStub(ch)

        c0 = nodes[0][1]
        ch0, stub0 = stub_of(c0)
        stub0.CreateStream(pb.Stream(stream_name="sensors"))
        poll_until(lambda: len(c0.placer.scores()) == 3, "three published nodes")
        zero_counts()
        stub0.ExecuteQuery(pb.CommandQuery(stmt_text=p17_query("a")))
        qid = c0.persistence.get_queries()[0].query_id

        def owners():
            return [i for i, (_s, c) in enumerate(nodes)
                    if i not in dead and qid in c.running_queries]

        poll_until(lambda: len(owners()) == 1, "the placed query's owner")
        place = next(d for _s, c in nodes
                     for d in c.placer.status()["decisions"]
                     if d["action"] == "place")
        samples, stop = [], threading.Event()

        def sampler():
            while not stop.is_set():
                samples.append(tuple(owners()))
                stop.wait(0.01)

        th = threading.Thread(target=sampler, daemon=True)
        th.start()
        producer = ColumnarProducer(ch0, "sensors")
        for f in frames[:P17B_KILL_AT]:
            append_retrying(producer, f)
        owner = owners()[0]
        _srv_drained([_srv_task(nodes[owner][1], qid)],
                     src.last_ts(items[P17B_KILL_AT - 1]))
        sink = c0.streams.get_logid("pka")

        def adopts(i):
            return [d for d in nodes[i][1].placer.status()["decisions"]
                    if d["action"] == "adopt"]

        before = {i: len(adopts(i)) for i in range(3)}
        _node_kill(*nodes[owner])
        dead.add(owner)
        t_kill = time.perf_counter()
        tail_at_kill = store.tail_lsn(sink)
        survivor = next(c for i, (_s, c) in enumerate(nodes)
                        if i not in dead)
        _chs, stub_s = stub_of(survivor)
        producer = ColumnarProducer(_chs, "sensors")
        for f in frames[P17B_KILL_AT:]:
            append_retrying(producer, f)
        poll_until(lambda: owners(), "an adoption", timeout=120)
        adopt_s = time.perf_counter() - t_kill
        poll_until(lambda: store.tail_lsn(sink) > tail_at_kill,
             "the adopter's first row", timeout=120)
        first_row_s = time.perf_counter() - t_kill
        adopter = owners()[0]
        task = _srv_task(nodes[adopter][1], qid)
        _srv_drained([task], src.last_ts(items[-1]))
        assert task.executor.device == dev, task.executor.device
        assert min(task.attached_lsns.values()) > LSN_MIN, \
            f"the adopter did not resume from a snapshot: {task.attached_lsns}"
        ref = src.reference(items)
        rows = check_member(member_finals(nodes[adopter][1], "pka", ref, "a"),
                            ref, dev, "the adopted query", "a")
        stop.set()
        th.join(10)
        counts = launch_counts()
        double = [s for s in samples if len(s) > 1]
        assert not double, f"two owners at {len(double)} samples"
        survivors = [i for i in range(3) if i not in dead]
        adopted = [d for i in survivors for d in adopts(i)[before[i]:]]
        assert len(adopted) == 1 and adopted[0]["query"] == qid \
            and adopted[0]["reason"] == "lease_lapsed", adopted
        fences = [d for i in survivors
                  for d in nodes[i][1].placer.status()["decisions"]
                  if d["action"] == "self_fence"]
        assert not fences, fences
        for name in ("wire_decode", "scatter_aggregate", "touched_extract",
                     "reset_close"):
            assert counts[name] > 0, (name, counts)
        out.update(launches=counts, rows=rows, owner=owner, adopter=adopter,
                   placed=dict(target=place["target"],
                               reason=place["reason"]),
                   adopt_s=adopt_s, first_row_s=first_row_s,
                   samples=len(samples), resumed_from=task.attached_lsns,
                   tick_ms_max={i: round(max(v, default=0) * 1e3, 3)
                                for i, v in ticks.items()})
    finally:
        for ch in channels:
            ch.close()
        for i, (server, ctx) in enumerate(nodes):
            if i in dead:
                continue
            server.stop(grace=0.1)
            ctx.shutdown()
        store.close()
    return out


def poll_sink(path, n: int) -> list:
    """The sink table's rows once it holds n (the connector writes
    behind the stream query)."""
    deadline = time.monotonic() + SRV_DRAIN_S
    pause = threading.Event()
    while True:
        rows = _sink_rows(path)
        if len(rows) >= n:
            assert len(rows) == n, f"the sink holds {len(rows)} rows"
            return rows
        assert time.monotonic() < deadline, f"the sink holds {len(rows)}"
        pause.wait(0.05)


def poll_caught_up(store) -> list:
    """The leader's follower status once every follower acked its op-log
    (the acks the appends waited for are a quorum of them)."""
    deadline = time.monotonic() + 60
    pause = threading.Event()
    while True:
        fol = store.follower_status()
        if all(f["alive"] and f["behind"] == 0 for f in fol):
            return fol
        assert time.monotonic() < deadline, fol
        pause.wait(0.05)


PHASE_S: dict[str, float] = {}   # each phase's wall seconds, in order
_PHASE_T0 = [0.0]


def phase_done(name: str) -> None:
    """Close a phase: its wall seconds since the last phase closed (or
    the start), logged on a line of their own and kept in PHASE_S."""
    now = time.perf_counter()
    PHASE_S[name] = now - _PHASE_T0[0]
    _PHASE_T0[0] = now
    log(f"phase {name}: {PHASE_S[name]:.1f} s wall")


def main() -> int:
    _PHASE_T0[0] = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hstream_tpu_torch.engine.kernels import build as kbuild

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    built = kbuild.build()
    log(f"build: {built.seconds:.1f} s -> {os.path.relpath(built.path)}")
    for line in built.log.splitlines():
        if "registers" in line or line.startswith("=="):
            log("  " + line.strip())
    phase_done("1-2 card and build")

    results: dict[str, dict] = {}
    paths = []
    head = headline_batch(dev, make_spec(1))
    check_decode(dev, results, head)
    states = check_scatter(dev, results, head)
    check_close(dev, results, states)
    check_rebase(dev, results)
    chg = changelog_batch(dev)
    check_expr(dev, results, chg)
    check_expr_blocks(dev, results)
    check_unaries(dev, results)
    k2_state = check_sketch_aggs(dev, results)
    check_topk(dev, results, chg)
    check_touched(dev, results, k2_state, chg)
    time_reset_close(dev, results, chg)
    time_changelog_step(dev, results, chg)
    check_session_step(dev, results)
    check_session_merge(dev, results)
    check_session_extract(dev, results)
    check_session_remap(dev, results)
    check_join_probe(dev, results)
    check_join_step(dev, results)
    check_join_evict(dev, results)
    check_unpack(dev, results)
    check_slot_close(dev, results, states, chg)
    check_sharded(dev, results)
    check_sharded_session(dev, results)
    check_sharded_join(dev, results)
    phase_done("3 kernel checks")

    for cfg in (1, 2):
        r = main_path(cfg, dev)
        paths.append(r)
        log(f"main path config {cfg}: {r['events_per_sec']:.0f} "
            f"events/s over {MAIN_BATCHES} x 2^20 records, close "
            f"latency median {r['close_latency_ms_median']:.2f} ms "
            f"({', '.join(f'{x:.2f}' for x in r['close_latency_ms'])}"
            f"), {r['windows_checked']} windows checked, launches "
            f"{r['launches']}, close_stats {r['close_stats']}, host "
            f"stages {json.dumps(r['pipeline_stages'])} [{card}]")
    phase_done("4-5 configs 1 and 2")

    r = wide_path(dev)
    paths.append(r)
    log(f"wide path (5b): {r['rows']} rows of {r['windows_checked']} "
        f"windows (24 aggregates over 20 columns, a WHERE) equal numpy; "
        f"{r['expression_blocks']} expression blocks a batch "
        f"({r['expression_instructions']} instructions), launches "
        f"{r['launches']}, close_stats {r['close_stats']}, "
        f"{r['events_per_sec']:.0f} events/s [{card}]")
    phase_done("5b wide")

    r = changelog_path(dev)
    paths.append(r)
    per_batch = {
        "wire_decode": results["wire_decode"]["ms_changelog"],
        "expression": results["expression"]["ms"],
        "scatter_aggregate": results["scatter_aggregate"]["ms_changelog"],
        "topk_fold": results["topk_fold"]["ms"],
        "touched_extract": results["touched_extract"]["ms"]}
    r["kernel_ms_per_batch"] = per_batch
    log(f"changelog path: {r['events_per_sec']:.0f} events/s over "
        f"{MAIN_BATCHES} x 2^20 records, {r['rows']} changelog rows "
        f"checked, quantile {json.dumps(r['quantile'])}, launches "
        f"{r['launches']}, close_stats {r['close_stats']}, kernel ms "
        f"per batch {json.dumps(per_batch)} (sum "
        f"{sum(per_batch.values()):.4f}), host stages "
        f"{json.dumps(r['pipeline_stages'])}; profiled window "
        f"{json.dumps(r['profile'])} [{card}]")
    phase_done("6 changelog")

    r = session_path(dev, results)
    paths.append(r)
    log(f"session path (BASELINE 4): {r['events_per_sec']:.0f} events/s "
        f"over {SESS_BATCHES} x 2^20 records, {r['rows']} sessions "
        f"checked {json.dumps(r['check'])}, close freshness ms "
        f"{[round(x, 2) for x in r['freshness_ms']]}, step "
        f"{r['profile']['step_ms_per_call']:.4f} ms and extract "
        f"{r['profile']['extract_ms_per_call']:.4f} ms device per call, "
        f"device busy {r['profile']['device_busy_share']:.4f} over "
        f"{SESS_PROFILE_BATCHES} batches, arena bytes {r['arena_bytes']}, "
        f"session_stats {r['session_stats']}, host stage s "
        f"{json.dumps(r['host_stage_s'])}; segment run "
        f"{r['segment']['events_per_sec']:.0f} events/s over "
        f"{SESS_SEG_BATCHES} batches, {r['segment']['rows']} sessions "
        f"checked, launches {r['segment']['launches']} [{card}]")
    phase_done("7 session")

    captured: dict = {}
    r = join_path(dev, results, captured)
    paths.append(r)
    log(f"join path (BASELINE 5): {r['events_per_sec']:.0f} events/s and "
        f"{r['change_rows_per_sec']:.0f} change rows/s over {JOIN_TIMED} "
        f"timed x 2^20 records ({JOIN_KEYS} keys), process_columnar p50 "
        f"{r['p50_call_ms']:.1f} ms p99 {r['p99_call_ms']:.1f} ms, "
        f"freshness ms {[round(x, 1) for x in r['freshness_ms']]}, host "
        f"join warm-up batches s "
        f"{[round(x, 2) for x in r['host_warmup_batches_s']]}, stage s "
        f"{json.dumps(r['stage_s'])}, {r['check']['windows']} (key, "
        f"window) finals checked of {r['check']['change_rows']} change "
        f"rows, timed join_stats {r['timed_join_stats']}, store cap "
        f"{r['store_cap']}, match_cap {r['match_cap']}, device bytes "
        f"{r['device_plane_bytes']}; profiled window "
        f"{json.dumps(r['profile'])} [{card}]")
    phase_done("8 join")
    r = join_fetch_path(dev, results, captured)
    paths.append(r)
    log(f"join match-fetch path (8b): {r['events_per_sec']:.0f} events/s "
        f"over {FETCH_TIMED} timed x 2^16 records, join_stats "
        f"{r['join_stats']}, check {json.dumps(r['check'])}, stage s "
        f"{json.dumps(r['stage_s'])} [{card}]")
    time_join_kernels(dev, results, captured)
    phase_done("8b match-fetch and the join kernels' timing")

    r = compiled_path(dev)
    paths.append(r)
    log(f"CompiledLattice path (9a): {r['events_per_sec']:.0f} events/s "
        f"over {MAIN_BATCHES} packed x 2^20 records, {r['windows_checked']} "
        f"windows checked by the per-slot close, launches {r['launches']} "
        f"[{card}]")
    phase_done("9a CompiledLattice")
    r = per_slot_path(dev)
    paths.append(r)
    log(f"per-slot close path (9b): {r['events_per_sec']:.0f} events/s, "
        f"{r['windows_closed']} windows closed, {r['windows_checked']} "
        f"checked, close_stats {r['close_stats']} [{card}]")
    phase_done("9b per-slot close")
    r = snapshot_path(dev)
    paths.append(r)
    log(f"snapshot path (10a-b): {r['rows_after_restore']} changelog rows "
        f"after the restore equal the uninterrupted run's, "
        f"{r['windows_checked']} windows' finals checked; snapshot "
        f"{json.dumps(r['snapshot'])} [{card}]")
    phase_done("10a-b snapshot")
    r = snapshot_side_paths(dev)
    paths.append(r)
    log(f"session + join snapshots (10c): session {json.dumps(r['session'])}"
        f"; join {json.dumps(r['join'])} [{card}]")
    phase_done("10c session and join snapshots")
    r = log_path(dev)
    paths.append(r)
    log(f"durable log path (11): {r['rows']} closed rows in {r['windows']} "
        f"windows equal numpy and the uninterrupted run; log "
        f"{r['store_bytes']} bytes, produce {r['produce_s']:.3f} s, append "
        f"{r['append_s']:.3f} s (JSON: build {r['json_build_s']:.3f} s, "
        f"append {r['json_append_s']:.3f} s); read {r['read_s']:.3f} s, "
        f"decode {r['decode_s']:.3f} s (JSON {r['json_decode_s']:.3f} s), "
        f"restart {r['restart_s']:.3f} s (blob {r['blob_bytes']} bytes); "
        f"{r['events_per_sec']:.0f} events/s from the log to rows "
        f"(columnar batches {r['columnar_events_per_sec']:.0f}), "
        f"device busy {r['device_busy_share']:.4f} over "
        f"{r['profile_batches']} batches, launches {r['launches']} "
        f"[{card}]")
    phase_done("11 durable log")

    r = traced_path(dev, results)
    paths.append(r)

    def ring(x):
        return (f"p50 {x['p50']:.4f} p99 = max of {x['samples']} "
                f"{x['max']:.4f}")

    log(f"traced path (12): kernel_device_ms step {ring(r['window']['step'])}"
        f" against the profiled decode + scatter "
        f"{r['window']['profiled_step_kernels_ms']:.4f}; close "
        f"{ring(r['window']['close'])} against the fused close "
        f"{r['window']['profiled_close_ms']:.4f}; session "
        f"{ring(r['session']['session'])} against the step "
        f"{r['session']['profiled_step_ms']:.4f}; probe "
        f"{ring(r['probe']['probe'])} against the probe + insert "
        f"{r['probe']['profiled_probe_ms']:.4f} (ms; each sample spans the "
        f"scope on the device's timeline: the host's launch path inside it "
        f"and the kernels); an empty "
        f"kernel reads {r['sampler_floor']['back to back']['p50']:.4f} back "
        f"to back, {r['sampler_floor']['after 20 ms idle']['p50']:.4f} "
        f"after 20 ms idle (p50); a step's host time inside the scope "
        f"{r['step_split']['idle']['host_p50']:.4f} (card idle through the "
        f"encode) and {r['step_split']['busy']['host_p50']:.4f} (kept busy), "
        f"its samples {r['step_split']['idle']['device_p50']:.4f} and "
        f"{r['step_split']['busy']['device_p50']:.4f} (p50); disarmed "
        f"state {json.dumps(r['window']['disarmed_state'])}; steady "
        f"compiles {r['window']['steady_compiles']} / "
        f"{r['session']['steady_compiles']} / "
        f"{r['probe']['steady_compiles']}; faults raised with the planes "
        f"byte-equal: {sorted(r['window']['faults'])} and "
        f"device.session.dispatch; {r['window']['windows_checked']} "
        f"windows, {r['session']['check']['sessions_checked']} sessions, "
        f"{r['probe']['check']['windows']} join (key, window)s equal numpy "
        f"[{card}]")
    phase_done("12 traced")

    r = srv13 = server_path(dev, results)
    paths.append(r)
    log(f"server path (13): server_columnar_eps median "
        f"{r['server_columnar_eps']:.0f} events/s, runs "
        f"{[round(x) for x in r['server_columnar_eps_runs']]} ({SRV_RUNS} "
        f"runs of {SRV_BLOCKS} framed AppendColumnarStream blocks of 2^18 "
        f"records, from the append to the drained watermark of the view "
        f"and the push query; frames encoded beforehand in "
        f"{r['encode_s']:.1f} s); the quiet pull's windows "
        f"{r['quiet_pull']}, {r['pulls_during_ingest']} pulls during ingest "
        f"each equal numpy over a whole-block prefix (first: "
        f"{r['pull_blocks_seen']}), {r['final_windows']} windows of the "
        f"final pull and {r['push_finals']} push-query finals equal numpy; "
        f"kernel_device_ms p50 from /metrics "
        f"{json.dumps({k: round(v, 4) for k, v in r['kernel_device_ms_p50'].items()})}"
        f"; device busy {r['profile']['device_busy_share']:.4f} over "
        f"{SRV_PROFILE} blocks ({r['profile']['wall_s']:.3f} s); ack "
        f"latency a block (a call each, {SRV_ACKS}) p50 "
        f"{r['ack_ms_p50']:.2f} ms, p99 {r['ack_ms_p99']:.2f}; launches "
        f"{r['launches']}; restart over file:// {json.dumps(r['restart'])}"
        f" [{card}]")
    phase_done("13 server")

    for cfg in (1, 2):
        r = sharded_path(cfg, dev)
        paths.append(r)
        log(f"sharded path (14a) config {cfg}: {r['events_per_sec']:.0f} "
            f"events/s with four shards on one card (2 data x 2 key; a "
            f"diagnostic, not comparable to one shard a card) over "
            f"{SH_BATCHES} x 2^20 records, {r['windows_checked']} windows "
            f"equal numpy, {r['rows_equal_single_card']} rows equal the "
            f"single-card executor's, close_stats {r['close_stats']}, "
            f"launches {r['launches']} [{card}]")
    r = sharded_push_path(dev)
    paths.append(r)
    log(f"sharded push query (14b): {r['events_per_sec']:.0f} events/s "
        f"with four shards on one card (a diagnostic), {r['change_rows']} "
        f"change rows, {r['windows_checked']} windows' finals equal numpy, "
        f"launches {r['launches']} [{card}]")
    r = sharded_server_path(dev)
    paths.append(r)
    log(f"sharded server (14c): serve(mesh_shape='2x2') ingested "
        f"{SH_SRV_BLOCKS} x 2^18 framed records at "
        f"{r['events_per_sec']:.0f} events/s (four shards on one card, a "
        f"diagnostic); the pull's windows {r['pulled_windows']} and "
        f"{r['push_finals']} push finals equal numpy; a mesh snapshot of "
        f"{r['snapshot_bytes']} bytes restored onto one card and back onto "
        f"a mesh, both equal numpy; launches {r['launches']} [{card}]")
    r = sharded_wide_path(dev)
    paths.append(r)
    log(f"sharded path past 16 partials (14d): config 1 on make_mesh(1, 24)"
        f" (24 key shards on one card) over {WIDE_MESH_BATCHES} x 2^20 "
        f"records, {r['rows_equal_single_card']} rows equal the single-card"
        f" executor's, a {r['blob_bytes']}-byte capture after "
        f"{WIDE_MESH_CAPTURE} batches restored onto one card with "
        f"{r['restored_rows_equal']} rows equal, close_stats "
        f"{r['close_stats']}, launches {r['launches']} [{card}]")
    phase_done("14 sharded lattice")

    r = sharded_session_path(dev, results)
    paths.append(r)
    log(f"sharded session path (15a): {r['events_per_sec']:.0f} events/s "
        f"with four key shards on one card (make_mesh(1, 4); a diagnostic, "
        f"not comparable to one shard a card) over {P15_SESS_BATCHES} x "
        f"2^20 records, {r['rows']} sessions checked "
        f"{json.dumps(r['check'])}, {r['rows_equal_single_card']} equal to "
        f"the single-card executor's, session_stats {r['session_stats']}, "
        f"arena bytes {r['arena_bytes']}; segment mode "
        f"{r['segment']['events_per_sec']:.0f} events/s over "
        f"{P15_SEG_BATCHES} batches, {r['segment']['rows']} sessions "
        f"checked ({r['segment']['rows_equal_single_card']} equal to the "
        f"single-card executor's); launches {r['launches']} [{card}]")
    phase_done("15a sharded session")
    p15_captured: dict = {}
    r = sharded_join_path(dev, p15_captured)
    paths.append(r)
    log(f"sharded join path (15b): {r['events_per_sec']:.0f} events/s over "
        f"{r['join_stats']['probe_batches']} device batches of 2^20 records "
        f"on make_mesh(2, 2) (four shards on one card, a diagnostic; the "
        f"two host-join batches before activation {r['host_batches_s']:.1f}"
        f" s), {r['check']['windows']} (key, window) finals equal numpy and "
        f"the single-card executor's, join_stats {r['join_stats']}, store "
        f"cap {r['store_cap']} a shard, launches {r['launches']} [{card}]")
    r = sharded_fetch_path(dev, p15_captured)
    paths.append(r)
    log(f"sharded match-fetch path (15c): {r['events_per_sec']:.0f} "
        f"events/s, join_stats {r['join_stats']}, check "
        f"{json.dumps(r['check'])}, launches {r['launches']} [{card}]")
    time_sharded_join(dev, results, p15_captured)
    del p15_captured
    phase_done("15b-c sharded join")
    r = sharded_session_server_path(dev)
    paths.append(r)
    log(f"sharded session server (15d): serve(mesh_shape='2x2') ingested "
        f"{P15_SRV_BLOCKS} x 2^18 framed records at "
        f"{r['events_per_sec']:.0f} events/s (a diagnostic), "
        f"{r['sessions_served']} closed sessions of the pull equal numpy; a "
        f"{r['snapshot_bytes']}-byte mesh snapshot restored onto one card "
        f"and back onto a mesh, each resuming with {r['resumed_one_card']} "
        f"/ {r['resumed_mesh']} sessions equal numpy; launches "
        f"{r['launches']} [{card}]")
    phase_done("15d sharded session server")

    r = replicated_path(dev)
    paths.append(r)
    log(f"replicated server (16): serve(replicate=2 followers, "
        f"replication_factor=3) over file:// stores, {r['blocks']} framed "
        f"blocks of 2^18 (half before the failover, half after) at "
        f"{r['events_per_sec']:.0f} events/s; ack latency a block p50 "
        f"{r['ack_ms_p50']:.2f} ms, p99 {r['ack_ms_p99']:.2f} ms (phase 13 "
        f"without replication: p50 {srv13['ack_ms_p50']:.2f}, p99 "
        f"{srv13['ack_ms_p99']:.2f}); {r['batches_at_failover']} data "
        f"batches on all three replicas at the failover, "
        f"{r['batches_at_end']} at the end, same LSNs and bytes, no "
        f"degraded ack; failover {r['failover_s']:.3f} s from the "
        f"promotion ({json.dumps(r['promoted'])}) to the first served pull "
        f"(the view's snapshot restored on the card); the view's window 0 "
        f"across the failover and the sink's {r['sink_rows']} rows equal "
        f"numpy; launches {r['launches']} [{card}]")
    phase_done("16 replicated server")

    r, un = packed_path(dev)
    paths += [r, un]
    log(f"packed queries (17a): serve(pack_queries=True), one pack group "
        f"{json.dumps(r['group'])} on the card, a refused query as a "
        f"standalone task ({r['explain_pack']}); {P17_BLOCKS} + "
        f"{P17_AFTER} framed blocks of 2^16 records (cut from phase 13's "
        f"2^18: the pack runner makes a row dict of every record for "
        f"each member) and two closers, a member terminated after block "
        f"{P17_BLOCKS}; RetraceGuard 0 over members 2 and 3; "
        f"{r['feeds_checked']} of {r['feeds']} feeds held to "
        f"ceil(members x n / {P17_CAP}) step launches (three members, a "
        f"block: {json.dumps(r['step_launches_three_members'])}); last "
        f"changes equal numpy {json.dumps(r['rows'])}; packed "
        f"{r['events_per_sec']:.0f} events/s against unpacked "
        f"{un['events_per_sec']:.0f} over blocks {P17_WARM}-"
        f"{P17_BLOCKS - 1} with three queries; unpacked scatter launches "
        f"a block {un['scatter_launches_a_block']:.2f}, rows equal "
        f"{json.dumps(un['rows_equal'])}; stage s "
        f"{json.dumps({k: round(v, 2) for k, v in r['stage_s'].items()})}"
        f", unpacked run {un['wall_s']:.2f} s; launches packed {r['launches']}"
        f", unpacked {un['launches']} [{card}]")
    r = placer_path(dev)
    paths.append(r)
    log(f"placer adoption (17b): three armed nodes over one store (lease "
        f"{P17_LEASE_MS} ms, tick 100 ms), placed {json.dumps(r['placed'])}"
        f", owner {r['owner']} killed after block {P17B_KILL_AT} of "
        f"{P17B_BLOCKS} (2^16 records each); node {r['adopter']} adopted "
        f"{r['adopt_s']:.3f} s after the kill, its first row "
        f"{r['first_row_s']:.3f} s after it, resumed from a snapshot on "
        f"the card at {json.dumps(r['resumed_from'])}; no two owners over "
        f"{r['samples']} samples; {r['rows']} last changes equal numpy; "
        f"placer tick ms max {json.dumps(r['tick_ms_max'])}; launches "
        f"{r['launches']} [{card}]")
    phase_done("17 packed queries and placer adoption")

    kernels = []
    for name, r in results.items():
        # a result may count another wrapper's launches (its "counter"),
        # on some paths only ("paths"), or on all but some ("skip_paths")
        counter = r.get("counter", name)
        launches = sum(p["launches"][counter] for p in paths
                       if p["config"] in r.get("paths", (p["config"],))
                       and p["config"] not in r.get("skip_paths", ()))
        kernels.append({"name": name, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": built.seconds,
                   "ptxas": built.log, "phase_s": PHASE_S,
                   "kernels": results, "main_paths": paths}, f, indent=1,
                  default=str)
    print("phase wall s " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_S.items()}))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
