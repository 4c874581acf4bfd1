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
   crossing a window end, the join's inner lattice at K = 2^19 on a
   match-sized feed), fused close
   (all three modes), rebase, and the changelog query's kernels (the
   expression interpreter over every op and type mix; NULL masks,
   COUNT(col) and quantile bins in the scatter and estimates in the
   close; the top-k fold; the touched extract; the reset-only close),
   the expression kernel's 21 unaries on every operand type the
   reference takes (NaN, +-inf, +-0, x.5 and -x.5, inputs outside the
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
   estimates near .5; the remap with codes at and above the table), and
   the join kernels (the probe + merge-insert and the probe alone at a
   match_cap below and above the total; the fused probe + window step
   over feed sources m, o, both and both_o with null and present bits
   on both sides, filter-NULL columns and a WHERE; the two-sided
   eviction with delta 0, > 0 and < 0; equal (code, ts) runs across
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
   keys, the same way;
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
   with bench.py's knobs, 14 warm-up and 20 timed batches of 2^20
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
12. a {"kernels": [...]} line (each kernel's launches on the main paths,
   its error against the plain version and its times), the card line,
   and last {"ok": true, "device": {...}}.

Device times come from torch.profiler over repeated calls, warmed by
spin kernels it leaves out; a profile whose per-kernel event counts are
not multiples of the calls is not used, and CUDA events time the calls
instead (profiled_calls).

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
import time

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


def profiled_calls(fn, iters: int, what: str = "") -> dict | None:
    """{device event name: device us} of `iters` calls of fn, or None
    when the profiler lost events: one call launches each of its
    kernels (and copies and fills) a fixed number of times, so each
    device event must be recorded a multiple of `iters` times; the
    profile is taken twice before it is given up. The profiler drops
    events now and then, and a short sum would pass for a fast kernel."""
    for _attempt in range(2):
        _, dev, counts = _profile(lambda: [fn() for _ in range(iters)])
        short = {k: c for k, c in counts.items() if c % iters}
        if counts and not short:
            return dev
    log(f"profiler: events lost over {iters} calls of {what or 'a call'} "
        f"({len(short)} kernels recorded a count that is not a multiple "
        f"of {iters}, {len(counts)} kernels in all): not used")
    return None


def kernel_ms(fn, iters: int) -> tuple[float, float, str]:
    """(ms, call_ms, source): the device time per call of fn from
    torch.profiler (the kernels and copies it launches, without the
    host's gaps between launches; "events" when the profiler lost or
    recorded no events, profiled_calls), and the time per call with CUDA
    events around many calls, which for a short kernel is the host's
    launch path and is then also the first number."""
    call = cuda_time_ms(fn, iters)
    dev = profiled_calls(fn, iters, getattr(fn, "__name__", ""))
    total = sum(dev.values()) if dev is not None else 0.0
    if total <= 0:
        return call, call, "events"
    return total / 1e3 / iters, call, "profiler"


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
            "join_evict": jl.join_evict}


def launch_counts() -> dict[str, int]:
    """Each kernel's launches; "expression_unaries" counts the expression
    kernel's launches whose programs ran a unary (B1b')."""
    from hstream_tpu_torch.engine import expr

    out = {name: fn.launches for name, fn in _wrappers().items()}
    out["expression_unaries"] = expr.eval_programs.unary_launches
    return out


def zero_counts() -> None:
    from hstream_tpu_torch.engine import expr

    for fn in _wrappers().values():
        fn.launches = 0
    expr.eval_programs.unary_launches = 0


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

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        self.kids = [rng.integers(0, N_KEYS, BATCH).astype(np.int32)
                     for _ in range(N_UNIQUE)]
        self.temps = [(np.rint(rng.normal(20.0, 5.0, BATCH) * 10)
                       .astype(np.float32) * np.float32(0.1))
                      for _ in range(N_UNIQUE)]
        self.ts_template = (np.arange(BATCH, dtype=np.int64)
                            * STREAM_MS_PER_BATCH) // BATCH

    def get(self, b: int):
        j = b % N_UNIQUE
        return (self.kids[j], BASE_TS + b * STREAM_MS_PER_BATCH
                + self.ts_template, self.temps[j])

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


def window_reference(per_key: list[dict], start: int, size: int) -> dict:
    """Aggregates of the main-path batches whose records all lie in
    [start, start + size)."""
    lo = max(0, -(-(start - BASE_TS) // STREAM_MS_PER_BATCH))
    hi = (start + size - BASE_TS) // STREAM_MS_PER_BATCH
    parts = [per_key[b % N_UNIQUE] for b in range(lo, min(hi, MAIN_BATCHES))]
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
    assert {"bp", "bpd", "bool1", "dec", "rawf", "rawi"} <= \
        {e for e, _ in encs}, encs
    assert {0, 1, 32} <= {b for e, b in encs if e == "bp"}, encs
    w, combo, bases, _ = head
    ms, call, src = kernel_ms(lambda: tp.decode_batch(w, combo, BATCH,
                                                      BATCH, bases), 50)
    plain = kernel_ms(lambda: tp.decode_batch_ref(w, combo, BATCH, BATCH,
                                                  bases), 5)[0]
    nbytes = w.numel() * 4 + BATCH * (4 + 4 + 1 + 4)
    b_ms, b_by = bound(nbytes, BATCH * len(combo) * 8)
    results["wire_decode"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/decode.cu",
        replaces="hstream_tpu/engine/transport.py:197",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src,
        wire_bytes_per_event=w.numel() * 4 / BATCH)
    log(f"wire_decode: {len(cases)} wires bit-exact over {sorted(encs)}; "
        f"{ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.4f})")


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
    records over three windows), keys spread over [0, K) with some
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
    temp = cols["temp"]
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
        spec = make_spec(cfg)
        slots = lattice.pad_slots(sl)
        a, b = copy_state(states[cfg]), copy_state(states[cfg])
        got = lattice.close_slots(spec, a, slots, mode)
        st = torch.from_numpy(slots).to(dev)
        want = None
        if mode != lattice.CLOSE_RESET:
            want = lattice.extract_slots_ref(spec, b, st)
        if mode != lattice.CLOSE_EXTRACT:
            lattice.reset_slots_ref(spec, b, st)
        torch.cuda.synchronize()
        if want is not None:
            assert torch.equal(got, want), f"close {cfg} {sl} {mode}: rows"
        for k in b:
            assert torch.equal(a[k], b[k]), f"close {cfg} {sl} {mode}: {k}"
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
    ms1, call1, _ = kernel_ms(lambda: lattice.close_slots(
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
    log(f"fused_close: {len(cases)} cases (3 modes) bit-exact; {ms:.4f} ms "
        f"(plain {plain:.4f}, bound {b_ms:.4f}); extract-only {ms1:.4f} ms "
        f"(plain {plain1:.4f}, bound {b1_ms:.5f})")


def check_rebase(dev, results):
    from hstream_tpu_torch.engine import lattice

    ss = torch.tensor([lattice.EMPTY_START, 90_000, 30_000,
                       lattice.EMPTY_START, 60_000], dtype=torch.int32,
                      device=dev)
    a, b = {"slot_start": ss.clone()}, {"slot_start": ss.clone()}
    lattice.rebase(a, 30_000)
    lattice.rebase_ref(b, 30_000)
    torch.cuda.synchronize()
    assert torch.equal(a["slot_start"], b["slot_start"]), "rebase differs"
    st = {"slot_start": ss[:3].clone()}     # W = 3, the headline lattice
    ms, call, src = kernel_ms(lambda: lattice.rebase(st, 0), 200)
    plain = kernel_ms(lambda: lattice.rebase_ref(st, 0), 200)[0]
    b_ms, b_by = bound(2 * 3 * 4, 3)
    results["rebase"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/rebase.cu",
        replaces="hstream_tpu/engine/lattice.py:1571",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, call_ms=call, ms_source=src)
    log(f"rebase: exact; {ms:.4f} ms (plain {plain:.4f}, bound "
        f"{b_ms:.6f})")


# ---- phases 4-5: the main path ----------------------------------------------

def check_rows(cfg, spec, rows, per_key, dev) -> int:
    """Every emitted row against the numpy reference of its window."""
    from hstream_tpu_torch.engine.sketches import hll_estimate

    size = spec.window.size_ms
    by_win: dict[int, list] = {}
    for r in rows:
        by_win.setdefault(r["winStart"], []).append(r)
    assert len(by_win) >= 2, f"config {cfg}: {len(by_win)} windows closed"
    for start, rs in by_win.items():
        ref = window_reference(per_key, start, size)
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
    negative operands, division by zero, NaN and +-inf, exact against the
    plain version; then timed on the changelog query's programs."""
    from hstream_tpu_torch.common.errors import SQLCodegenError
    from hstream_tpu_torch.engine import expr as ex
    from hstream_tpu_torch.engine.types import ColumnType as CT, Schema

    schema = Schema.of(f=CT.FLOAT, g=CT.FLOAT, i=CT.INT, j=CT.INT,
                       b=CT.BOOL, c=CT.BOOL)
    progs, refused = [], 0
    for e in expr_cases():
        try:
            progs.append(ex.compile_device(e, schema))
        except SQLCodegenError:
            refused += 1
    where = ex.compile_device(ex.BinOp("<>", ex.Col("f"), ex.Col("g")),
                              schema)
    cols = expr_columns(dev, 1 << 16, 31)
    valid0 = torch.from_numpy(
        np.random.default_rng(32).integers(0, 9, 1 << 16) > 0).to(dev)
    dtypes = set()
    for k in range(0, len(progs), 12):
        chunk = [(p, f"__e{k + m}") for m, p in enumerate(progs[k:k + 12])]
        got, valid = dict(cols), valid0.clone()
        ex.eval_programs(chunk + [(where, None)], got, valid)
        torch.cuda.synchronize()
        for p, name in chunk:
            want = p(cols)
            dtypes.add(p.dtype)
            assert same_bits(got[name], want), f"expression {k}: {name}"
        assert torch.equal(valid, valid0 & where(cols)), "expression: WHERE"
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
        f"at compile); {ms:.4f} ms (plain {plain:.4f}, "
        f"bound {b_ms:.4f})")


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
    large arguments (1e4 .. 3.4e38) and values past exp's and sinh's
    overflow; i: int32 over its range and small; b: bools."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 10, n).astype(np.float32)
    f[::5] = np.rint(f[::5] * 2) / 2             # halves and integers
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5,
                        1.5, -1.5, 2.5, -2.5, 20.5, -20.5, 1.0, -1.0, 0.99,
                        -0.99, 1.01, -3.0, 0.25, 1e4, -1e4, 1e10, -1e20,
                        1e30, 3.4e38, -3.4e38, 88.0, 89.0, -104.0, 710.0,
                        16.0, 16.1, 15.9], np.float32)
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
    """Ties, -0.0 / +0.0, NaN and +-inf, cells with fewer records than k."""
    rng = np.random.default_rng(seed)
    n = 1 << 18
    pool = np.array([-2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 1.0, 2.0, 3.0, np.nan,
                     np.inf, -np.inf, 1e30, -1e30], np.float32)
    v = pool[rng.integers(0, len(pool), n)]
    v[::3] = (rng.normal(0, 2, v[::3].shape[0]) * 4).round() / 4
    key = rng.integers(0, 600, n).astype(np.int32)
    key[::97] = rng.integers(600, 1024, key[::97].shape[0])  # 1-3 records
    ts = (200_000 + rng.integers(0, 30_000, n)).astype(np.int32)
    valid = rng.integers(0, 30, n) > 0
    cols = {"temp": torch.from_numpy(v).to(dev)}
    for i in range(4):
        cols[f"__null_a{i}"] = torch.from_numpy(rng.random(n) < 0.03).to(dev)
    t = torch.from_numpy
    return t(key).to(dev), t(ts).to(dev), t(valid).to(dev), cols


def check_topk(dev, results, chg):
    """K4: both variants bit-exact against the plain fold, k = 3 and 1,
    two rounds; then timed on the changelog batch."""
    from hstream_tpu_torch.engine import AggKind as A, AggSpec
    from hstream_tpu_torch.engine import TumblingWindow, lattice
    from hstream_tpu_torch.engine.expr import Col

    x = Col("temp")
    spec = lattice.LatticeSpec(
        n_keys=1024, window=TumblingWindow(10_000, grace_ms=0),
        aggs=(AggSpec(A.TOPK, "t3", input=x, k=3),
              AggSpec(A.TOPK_DISTINCT, "d3", input=x, k=3),
              AggSpec(A.TOPK, "t1", input=x, k=1),
              AggSpec(A.TOPK_DISTINCT, "d1", input=x, k=1)))
    state = lattice.init_state(spec, dev)
    for rnd in range(2):
        key, ts, valid, cols = topk_inputs(dev, 50 + rnd)
        a, b = copy_state(state), copy_state(state)
        lattice.topk_step(spec, a, 205_000, key, ts, valid, cols)
        lattice.topk_step_ref(spec, b, 205_000, key, ts, valid, cols)
        torch.cuda.synchronize()
        for k in b:
            assert same_bits(a[k], b[k]), f"topk round {rnd}: {k}"
        state = b
    assert bool(torch.isneginf(state["a0_topk"][:, :, 2]).any()), \
        "no cell with fewer records than k"
    zeros = {k: (int((v.view(torch.int32) == 0).sum()),
                 int((v.view(torch.int32) == -(1 << 31)).sum()))
             for k, v in state.items() if k.startswith("a")}
    # timed on the changelog batch: steady state, planes already filled
    cspec, progs, (key, ts, valid, cols), _ = chg
    from hstream_tpu_torch.engine import expr as ex

    cols, valid = dict(cols), valid.clone()
    ex.eval_programs(progs, cols, valid)
    st = lattice.init_state(cspec, dev)
    lattice.topk_step(cspec, st, -1, key, ts, valid, cols)
    ms, call, src = kernel_ms(lambda: lattice.topk_step(
        cspec, st, -1, key, ts, valid, cols), 30)
    plain = kernel_ms(lambda: lattice.topk_step_ref(
        cspec, st, -1, key, ts, valid, cols), 3)[0]
    cell = key.long() * cspec.n_slots + torch.remainder(
        torch.div(ts, 10_000, rounding_mode="floor"), cspec.n_slots).long()
    okey = (cell << 32) | ((1 << 31) - 1 - lattice._order_key(cols["temp"]))
    lib = kernel_ms(lambda: torch.sort(okey), 10)[0]
    touched_cells = int(torch.unique(cell).numel())
    nbytes = BATCH * (4 + 4 + 1 + 4 + 2) + 2 * 2 * touched_cells * TOPK_K * 4
    b_ms, b_by = bound(nbytes, BATCH * 2 * 4)
    results["topk_fold"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/topk.cu",
        replaces="hstream_tpu/engine/lattice.py:258",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, call_ms=call, ms_source=src)
    log(f"topk_fold: both variants, k 3 and 1, bit-exact over ties, +-0.0 "
        f"(kept +0.0/-0.0 per plane: {zeros}), NaN, +-inf, short cells; "
        f"{ms:.4f} ms (plain {plain:.4f}, library sort {lib:.4f}, bound "
        f"{b_ms:.4f})")


def check_touched(dev, results, k2_state, chg):
    """K3: nothing touched, everything touched, n = max_out, n > max_out,
    and lattices of more than one 4096-cell block, packed buffers exact;
    then timed at the changelog path's shapes."""
    from hstream_tpu_torch.engine import lattice

    spec = k2_spec()
    K, W = spec.n_keys, spec.n_slots
    cases = []
    st = copy_state(k2_state)
    cases.append(("as stepped", spec, st, K * W))
    nothing = copy_state(k2_state)
    nothing["touched"].zero_()
    cases.append(("nothing", spec, nothing, K * W))
    every = copy_state(k2_state)
    every["touched"].fill_(True)
    cases.append(("everything", spec, every, K * W))
    n_hit = int(k2_state["touched"].sum())
    cases.append(("n = max_out", spec, copy_state(k2_state), n_hit))
    cases.append(("n > max_out", spec, copy_state(k2_state), n_hit // 2))
    for big in (2048, 6000):
        bspec = k2_spec(big)
        key, ts, valid, cols = k2_inputs(dev, 60 + big, big)
        bst = lattice.init_state(bspec, dev)
        lattice.scatter_step_ref(bspec, bst, 205_000, key, ts, valid, cols)
        lattice.topk_step_ref(bspec, bst, 205_000, key, ts, valid, cols)
        cases.append((f"K*W = {big * W}", bspec, bst, big * W))
        full = copy_state(bst)
        full["touched"].fill_(True)
        cases.append((f"K*W = {big * W}, everything", bspec, full, big * W))
    for name, sp, s0, mo in cases:
        a, b = copy_state(s0), copy_state(s0)
        got = lattice.extract_touched(sp, a, mo)
        want = lattice.extract_touched_ref(sp, b, mo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"touched {name}: packed rows differ"
        assert not bool(a["touched"].any()), f"touched {name}: not cleared"
        for k in b:
            assert torch.equal(a[k], b[k]), f"touched {name}: {k}"
    # timed at the changelog path's shapes: one headline batch touched
    # one slot of every key
    cspec, progs, (key, ts, valid, cols), _ = chg
    cst = lattice.init_state(cspec, dev)
    lattice.step_decoded(cspec, cst, -1, key, ts, valid.clone(), dict(cols),
                         progs)
    saved = cst["touched"].clone()
    mo = lattice.touched_max_out(cspec, BATCH)
    refill, refill_call, _ = kernel_ms(
        lambda: cst["touched"].copy_(saved), 50)
    ms, call, src = kernel_ms(lambda: (cst["touched"].copy_(saved),
                                       lattice.extract_touched(cspec, cst,
                                                               mo)), 50)
    ms, call = ms - refill, call - refill_call
    plain = kernel_ms(lambda: (cst["touched"].copy_(saved),
                               lattice.extract_touched_ref(cspec, cst, mo)),
                      10)[0] - refill
    lib = kernel_ms(lambda: torch.nonzero(saved), 50)[0]
    n = int(saved.sum())
    rows = 3 + lattice.out_rows(cspec)
    per_cell = 4 + 4 + 4 + 4 * cspec.qcfg.n_bins + 2 * TOPK_K * 4
    b_ms, b_by = bound(2 * cspec.n_keys * cspec.n_slots + n * per_cell
                       + rows * mo * 4, n * (cspec.qcfg.n_bins * 3 + 40))
    results["touched_extract"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/touched.cu",
        replaces="hstream_tpu/engine/lattice.py:693",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, call_ms=call, ms_source=src,
        touched=n, max_out=mo)
    log(f"touched_extract: {len(cases)} cases bit-exact (n=0, all, n = and "
        f"> max_out, 2 and 5 blocks); {ms:.4f} ms for {n} cells (plain "
        f"{plain:.4f}, library nonzero {lib:.4f}, bound {b_ms:.4f})")


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
    results["wire_decode"]["ms_changelog"] = kernel_ms(
        lambda: tp.decode_batch(w, combo, BATCH, BATCH, bases), 50)[0]
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
                 "delta_fixup_kernel": "wire_decode",
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
    for name, arena_e, seg_e in (
            ("cap = 0", sl.init_session_arena(spec, 0, dev),
             session_seg(dev, spec, 73, 3000, 200, 0)),
            ("no segments", base, session_seg(dev, spec, 75, 0, 1, 0)),
            ("m below one tile", small,
             session_seg(dev, spec, 76, 100, 20, 2 * SESS_GAP)),
            ("one bucket", sl.init_session_arena(spec, 0, dev), one)):
        e, _w = merge_vs_plain(spec, arena_e, seg_e, SESS_GAP, close_cut,
                               delta, f"session_merge ({name})")
        err = max(err, e)
    results["session_merge"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/session_merge.cu",
        replaces="hstream_tpu/engine/lattice.py:1432",
        max_abs_err=err)
    log(f"session_merge: {nseg} segments (sentinel pads, +-inf and -0.0 "
        f"MIN/MAX) into an arena with evicted and retired entries, delta "
        f"{delta}; no arena slots, no segments, m below one tile, one "
        f"bucket: exact, SUM/AVG within their bound (max err {err:.3g})")


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
    results["session_extract"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/session_extract.cu",
        replaces="hstream_tpu/engine/lattice.py:1504",
        max_abs_err=0.0)
    log(f"session_extract: {len(pick)} slots + {int((slots < 0).sum())} "
        f"pads, 64 empty histograms, HLL estimates within "
        f"{float(frac[near].max()):.2g} of .5, +-inf MIN/MAX, AVG n = 0: "
        f"bit-exact")


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
    results["session_remap"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/session_remap.cu",
        replaces="hstream_tpu/engine/lattice.py:1553",
        max_abs_err=0.0)
    log("session_remap: codes below, at and above lcap and the sentinel, "
        "an evicting table: exact")


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
    """For the block's duration each session wrapper (each join wrapper,
    with `joins`) is called through a _Capture hook; the wrappers are
    restored on exit. The remap's and the eviction's first calls are
    kept whenever they come; the step's and merge's fresh arena not."""
    from hstream_tpu_torch.engine import join_lattice as jl
    from hstream_tpu_torch.engine import session_lattice as sl

    mod, names, always = ((jl, JOIN_KERNELS, "join_evict") if joins
                          else (sl, SESS_KERNELS, "session_remap"))
    orig = {n: getattr(mod, n) for n in names}
    for n, fn in orig.items():
        drop = (2,) if n in ("session_step", "session_merge") else ()
        setattr(mod, n, _Capture(n, fn, store, armed, always, drop))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(mod, n, fn)


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
                   "sort_pass_kernel": "sort",
                   "scan_": "scan", "init_copy_kernel": "init",
                   "fold_": "fold", "record_scatter": "scatter",
                   "fixup_kernel": "fixup", "extract_kernel": "extract",
                   "remap_kernel": "remap", "Memcpy HtoD": "h2d_copy",
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


def join_values(rng, n_cols: int, n: int) -> np.ndarray:
    """int32 [n_cols, n] column planes of f32 bits: column 0 multiples of
    1/4 (a few NaN and inf), column 1 small integers, column 2 0.0 / 1.0,
    so every float sum is exact in any order."""
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
        out[c] = v.view(np.int32)
    return out


def join_store(dev, rng, cap: int, n_cols: int, n_live: int,
               codes: int = 6) -> dict:
    """A sorted store on the card: n_live entries over few codes and a
    narrow ts range (equal (code, ts) runs, negative relative times),
    then sentinel slots that keep random flags and columns, as evicted
    entries do."""
    code = np.full(cap, JOIN_SENT, np.int32)
    ts = np.zeros(cap, np.int32)
    c = rng.integers(0, codes, n_live)
    t = rng.integers(-60, 120, n_live)
    o = np.lexsort((t, c))
    code[:n_live], ts[:n_live] = c[o], t[o]
    flags = rng.integers(0, 1 << 28, cap).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in (
        ("code", code), ("ts", ts), ("flags", flags),
        ("cols", join_values(rng, n_cols, cap)))}


def join_batch(dev, rng, bcap: int, n: int, n_cols: int, codes: int = 6,
               n_keys: int = 8) -> torch.Tensor:
    """A batch sorted by (code, ts), padded with (sentinel, 0)."""
    buf = np.zeros((4 + n_cols, bcap), np.int32)
    c = rng.integers(0, codes, n)
    t = rng.integers(-60, 150, n)
    o = np.lexsort((t, c))
    buf[0, :n], buf[1, :n] = c[o], t[o]
    buf[0, n:] = JOIN_SENT
    buf[2, :n] = rng.integers(0, n_keys, n)
    buf[3, :n] = rng.integers(0, 1 << 28, n)
    buf[4:, :n] = join_values(rng, n_cols, n)
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


def check_join_probe(dev, results):
    """B15 (probe in pack mode + merge-insert) and B16 (probe only, at a
    match_cap below the total and then above it), exact."""
    from hstream_tpu_torch.engine import join_lattice as jl

    for i, (cap, bcap, n, nm, no, mc, cutoff) in enumerate(JOIN_CASES):
        rng = np.random.default_rng(100 + i)
        mine = join_store(dev, rng, cap, nm, cap // 3)
        other = join_store(dev, rng, cap, no, cap // 2)
        bt = join_batch(dev, rng, bcap, n, nm)
        want_m, want_p = jl.join_probe_insert_ref(mine, other, bt, n,
                                                  JOIN_WITHIN, cutoff, mc, nm)
        before = jl.join_probe_insert.launches
        got_m, got_p = jl.join_probe_insert(
            mine, other, bt, n, JOIN_WITHIN, cutoff, mc, nm,
            out=jl.empty_join_store(cap, nm, dev))
        torch.cuda.synchronize()
        assert jl.join_probe_insert.launches == before + 1
        assert torch.equal(want_p, got_p), f"join probe differs, case {i}"
        assert stores_equal(want_m, got_m), f"join insert differs, case {i}"
        assert jl.store_sorted(got_m)
        total = int(want_p[0, 0])
        for width in (max(total // 2, 1), max(total, 1) * 2):
            want = jl.join_probe_ref(other, bt, n, JOIN_WITHIN, cutoff,
                                     width, nm)
            got = jl.join_probe_only(other, bt, n, JOIN_WITHIN, cutoff,
                                     width, nm)
            torch.cuda.synchronize()
            assert torch.equal(want, got), f"join probe-only differs, {i}"
            assert int(got[0, 0]) == total
    src = "hstream_tpu_torch/engine/kernels/csrc/"
    results["join_probe_insert"] = dict(
        route="cuda", source=src + "join_probe.cu",
        sources=[src + "join_core.cuh", src + "join_probe.cu",
                 src + "join_insert.cu"],
        replaces="hstream_tpu/engine/lattice.py:984", max_abs_err=0.0)
    results["join_probe_only"] = dict(
        route="cuda", source=src + "join_probe.cu",
        replaces="hstream_tpu/engine/lattice.py:1001", max_abs_err=0.0)
    log("join_probe_insert / join_probe_only: equal (code, ts) runs across "
        "store and batch, sentinels that kept flags and columns, dead "
        "entries below the cutoff, negative times, n = 0, a match_cap "
        "below the total (true total in the header) and above it: exact")


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


def step_vs_plain_join(args: tuple, what: str) -> int:
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
                                          batch.device)}
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
                rng = np.random.default_rng(200 + i * 4 + where)
                ex = join_inner(dev, where)
                args = (join_store(dev, rng, cap, 3, cap // 3),
                        join_store(dev, rng, cap, 3, cap // 2),
                        join_batch(dev, rng, bcap, n, 3), n, JOIN_WITHIN,
                        cutoff, mc, 3, ex.spec, ex.state, 120, 300,
                        ex._progs, join_feed(feed_name, ex, where))
                step_vs_plain_join(args, f"join_probe_step case {i} "
                                   f"{feed_name} where={where}")
                n_checked += 1
    results["join_probe_step"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/join_probe.cu",
        sources=["join_probe.cu (feed mode)", "expr.cu", "scatter.cu",
                 "join_insert.cu"],
        replaces="hstream_tpu/engine/lattice.py:1082", max_abs_err=0.0)
    log(f"join_probe_step: {n_checked} fused calls (feed sources m, o, both, "
        "both_o; null and present bits on both sides; filter-NULL and "
        "WHERE; truncating match_cap; n = 0) against the plain version: "
        "store and every state plane exact")


def check_join_evict(dev, results):
    """B18: both sides at once, delta 0, > 0 and < 0, dead entries below
    the cutoff and sentinels that kept their columns; and the remap
    kernel's sentinel flag (the join's code remap)."""
    from hstream_tpu_torch.engine import join_lattice as jl
    from hstream_tpu_torch.engine import session_lattice as sl

    for i, (cap, cutoff, delta) in enumerate(
            [(256, 0, 0), (256, 40, 37), (256, -20, -100),
             (1 << 16, 30, 0), (1 << 16, -(1 << 31), 5)]):
        rng = np.random.default_rng(300 + i)
        left = join_store(dev, rng, cap, 3, 2 * cap // 3)
        right = join_store(dev, rng, cap, 1, cap // 3)
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
    log("join_evict: both sides, delta 0, > 0 and < 0, dead entries and "
        "sentinels with columns: exact; the remap kernel's sentinel flag "
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
JOIN_TIMED = 20
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
_JOIN_EVENTS = {"bounds_kernel": "probe", "scan_tiles_kernel": "probe",
                "ccnt_kernel": "probe", "feed_kernel": "probe",
                "pack_kernel": "probe", "merge_kernel": "insert",
                "count_kernel": "evict", "move_kernel": "evict",
                "scatter_private": "scatter", "scatter_cluster": "scatter",
                "scatter_global": "scatter", "expr_kernel": "expression",
                "touched_": "touched_extract", "close_kernel": "close",
                "Memcpy HtoD": "h2d_copy", "Memcpy DtoH": "d2h_copy"}


def _by_stage(devt: dict, batches: int) -> dict:
    per: dict[str, float] = {}
    for name, us in devt.items():
        k = next((v for e, v in _JOIN_EVENTS.items() if e in name), "other")
        per[k] = per.get(k, 0.0) + us / 1e3 / batches
    return per


def join_path(dev, results, captured) -> dict:
    """BASELINE config 5 at full width: 14 warm-up and 20 timed batches of
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

    missing = [k for k in ("join_probe_insert_step", "join_evict",
                           "join_probe_insert") if k not in captured]
    assert not missing, f"the join paths made no call of {missing}"

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
    results["join_probe_step"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=cap, n=n, matches=total,
        match_cap=match_cap, stages_ms=stages)
    log(f"join_probe_step at the path's shapes (store cap {cap}, {n} "
        f"records, {total} matches, match_cap {match_cap}): kernel and "
        f"plain agree; {ms:.4f} ms (plain {plain:.4f}, torch.searchsorted "
        f"of the {2 * n} bounds {lib:.4f}, bound {b_ms:.4f} by {b_by}; by "
        f"stage {json.dumps(stages)})")
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
    results["join_evict"].update(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        call_ms=call, ms_source=srcm, cap=ecap, cutoff=e_cutoff,
        delta=delta, live=gn.tolist())
    log(f"join_evict of the path's two {ecap}-slot stores (live "
        f"{gn.tolist()}, delta {delta}): exact against plain; {ms:.4f} ms "
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


def main() -> int:
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

    results: dict[str, dict] = {}
    paths = []
    head = headline_batch(dev, make_spec(1))
    check_decode(dev, results, head)
    states = check_scatter(dev, results, head)
    check_close(dev, results, states)
    check_rebase(dev, results)
    chg = changelog_batch(dev)
    check_expr(dev, results, chg)
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
    r = join_fetch_path(dev, results, captured)
    paths.append(r)
    log(f"join match-fetch path (8b): {r['events_per_sec']:.0f} events/s "
        f"over {FETCH_TIMED} timed x 2^16 records, join_stats "
        f"{r['join_stats']}, check {json.dumps(r['check'])}, stage s "
        f"{json.dumps(r['stage_s'])} [{card}]")
    time_join_kernels(dev, results, captured)

    r = compiled_path(dev)
    paths.append(r)
    log(f"CompiledLattice path (9a): {r['events_per_sec']:.0f} events/s "
        f"over {MAIN_BATCHES} packed x 2^20 records, {r['windows_checked']} "
        f"windows checked by the per-slot close, launches {r['launches']} "
        f"[{card}]")
    r = per_slot_path(dev)
    paths.append(r)
    log(f"per-slot close path (9b): {r['events_per_sec']:.0f} events/s, "
        f"{r['windows_closed']} windows closed, {r['windows_checked']} "
        f"checked, close_stats {r['close_stats']} [{card}]")
    r = snapshot_path(dev)
    paths.append(r)
    log(f"snapshot path (10a-b): {r['rows_after_restore']} changelog rows "
        f"after the restore equal the uninterrupted run's, "
        f"{r['windows_checked']} windows' finals checked; snapshot "
        f"{json.dumps(r['snapshot'])} [{card}]")
    r = snapshot_side_paths(dev)
    paths.append(r)
    log(f"session + join snapshots (10c): session {json.dumps(r['session'])}"
        f"; join {json.dumps(r['join'])} [{card}]")
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

    kernels = []
    for name, r in results.items():
        launches = sum(p["launches"][name] for p in paths)
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
                   "ptxas": built.log,
                   "kernels": results, "main_paths": paths}, f, indent=1,
                  default=str)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
