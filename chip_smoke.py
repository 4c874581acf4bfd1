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
   calls computing the same function: wire decode, scatter, fused close
   (all three modes), rebase, and the changelog query's kernels (the
   expression interpreter over every op and type mix; NULL masks,
   COUNT(col) and quantile bins in the scatter and estimates in the
   close; the top-k fold; the touched extract; the reset-only close);
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
7. a {"kernels": [...]} line (each kernel's launches on the main paths,
   its error against the plain version and its times), the card line,
   and last {"ok": true, "device": {...}}.

Inputs come from fixed seeds with numpy. Tolerances: integer planes,
slot_start, HLL registers and estimates, quantile bins and estimates,
top-k planes, MIN/MAX, counts, expression results and every packed close
and changelog row are exact. SUM/AVG accumulators add with float atomics
in an order that changes from run to run; two summation orders of n
terms differ by at most 2*n*2^-24*sum|x|, the bound each SUM cell (and
each AVG cell's sum) is held to. The changelog path's quantile estimates
may sit one bucket from numpy's only for a key whose data holds a value
within one float32 ulp of a bin edge (numpy's log is not the card's);
the run reports how many. Details go to smoke_out/chip_smoke.json.
"""

from __future__ import annotations

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


def profiled(fn):
    """(fn's result, {device event name: device us}) with fn run under
    torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key: _device_us(e) for e in prof.key_averages()
                 if _device_us(e) > 0}


def kernel_ms(fn, iters: int) -> tuple[float, float, str]:
    """(ms, call_ms, source): the device time per call of fn from
    torch.profiler (the kernels and copies it launches, without the
    host's gaps between launches; "events" when the profiler records
    none), and the time per call with CUDA events around many calls,
    which for a short kernel is the host's launch path."""
    call = cuda_time_ms(fn, iters)
    _, dev = profiled(lambda: [fn() for _ in range(iters)])
    total = sum(dev.values())
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

    return {"wire_decode": transport.decode_batch,
            "expression": expr.eval_programs,
            "scatter_aggregate": lattice.scatter_step,
            "topk_fold": lattice.topk_step,
            "fused_close": lattice.close_slots,
            "reset_close": lattice.reset_slots,
            "touched_extract": lattice.extract_touched,
            "rebase": lattice.rebase}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


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


def sum_plane(cfg: int) -> str:
    return "a1_sum" if cfg == 1 else "a0_avg"


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


def awkward_inputs(dev, seed: int):
    """A decoded batch with the hard cases mixed in: records before the
    epoch (negative ts), late records, invalid rows, keys out of range,
    NaN, inf and -0.0 inputs, records over three windows."""
    rng = np.random.default_rng(seed)
    n = BATCH
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


def sum_bound(spec, cfg, prior, wm, key, ts, valid, cols):
    """Per SUM/AVG cell: 2*n*2^-24*sum|x| over the cell's addends (the
    prior value counts as one): the plain step over |x| gives n and
    sum|x| (in float32, widened by 1e-6 for its own rounding)."""
    from hstream_tpu_torch.engine import lattice

    dev = key.device
    st = lattice.init_state(spec, dev)
    lattice.scatter_step_ref(spec, st, wm, key, ts, valid,
                             {"temp": cols["temp"].abs()})
    name = sum_plane(cfg)
    n = st["count"] if cfg == 1 else st["a0_avg_n"]
    abs_sum = st[name].double() * (1 + 1e-6) + prior[name].double().abs()
    return 2 * (n.double() + 1) * U * abs_sum


def check_states(spec, cfg, got, want, lim, what) -> float:
    """Exact on every plane but the SUM/AVG sums, held to `lim`."""
    err = 0.0
    for k in want:
        if k == sum_plane(cfg):
            d = (got[k].double() - want[k].double()).abs()
            assert bool((d <= lim).all()), f"{what}: {k} beyond the bound"
            err = max(err, d.max().item())
        else:
            assert torch.equal(got[k], want[k]), f"{what}: {k} differs"
    return err


def check_scatter(dev, results, head):
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.sketches import hll_update_indices

    err = 0.0
    states = {}
    for cfg in (1, 2):
        spec = make_spec(cfg)
        wm = 205_000           # the window [190 s, 200 s) is late
        key, ts, valid, cols = awkward_inputs(dev, 20 + cfg)
        state = lattice.init_state(spec, dev)
        for rnd in range(2):   # the second round lands on a filled state
            a, b = copy_state(state), copy_state(state)
            lattice.scatter_step(spec, a, wm, key, ts, valid, cols)
            lattice.scatter_step_ref(spec, b, wm, key, ts, valid, cols)
            torch.cuda.synchronize()
            lim = sum_bound(spec, cfg, state, wm, key, ts, valid, cols)
            err = max(err, check_states(spec, cfg, a, b, lim,
                                        f"scatter config {cfg} round {rnd}"))
            state = b
        assert int(state["count"].sum()) > 0
        states[cfg] = state
    # time at the main path's shapes: the headline batch, config 1
    spec = make_spec(1)
    st = lattice.init_state(spec, dev)
    _, _, _, (key, ts, valid, cols) = head
    wm = -1
    ms, call, src = kernel_ms(lambda: lattice.scatter_step(
        spec, st, wm, key, ts, valid, cols), 30)
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
    # config 2's lattice on the same records, at its epoch offset (its
    # epoch sits 110 s before the first record): six windows each
    spec2 = make_spec(2)
    st2 = lattice.init_state(spec2, dev)
    ts2 = ts + 100_000
    lattice.scatter_step(spec2, st2, wm, key, ts2, valid, cols)
    assert int(st2["count"].sum()) == 6 * BATCH
    ms2 = kernel_ms(lambda: lattice.scatter_step(
        spec2, st2, wm, key, ts2, valid, cols), 30)[0]
    slots_hit = int(torch.unique(slot).numel())
    planes = spec.n_keys * slots_hit * (4 + 4 + 1024)  # count, sum, HLL
    nbytes = BATCH * (4 + 4 + 1 + 4) + 2 * planes
    b_ms, b_by = bound(nbytes, BATCH * 40)
    results["scatter_aggregate"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/scatter.cu",
        replaces="hstream_tpu/engine/lattice.py:138",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, call_ms=call, ms_source=src,
        ms_config2=ms2)
    log(f"scatter_aggregate: both configs exact, SUM/AVG within the "
        f"atomic-order bound (max err {err:.3g}); {ms:.4f} ms (plain "
        f"{plain:.4f}, library {lib_ms:.4f}, bound {b_ms:.4f}); config 2 "
        f"lattice {ms2:.4f} ms")
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
            U("SQRT", f)]                      # refused at compile
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
                 "scatter_kernel": "scatter_aggregate",
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
    head = headline_batch(dev, make_spec(1))
    check_decode(dev, results, head)
    states = check_scatter(dev, results, head)
    check_close(dev, results, states)
    check_rebase(dev, results)
    chg = changelog_batch(dev)
    check_expr(dev, results, chg)
    k2_state = check_sketch_aggs(dev, results)
    check_topk(dev, results, chg)
    check_touched(dev, results, k2_state, chg)
    time_reset_close(dev, results, chg)
    time_changelog_step(dev, results, chg)

    paths = []
    for cfg in (1, 2):
        r = main_path(cfg, dev)
        paths.append(r)
        log(f"main path config {cfg}: {r['events_per_sec']:.0f} events/s "
            f"over {MAIN_BATCHES} x 2^20 records, close latency median "
            f"{r['close_latency_ms_median']:.2f} ms "
            f"({', '.join(f'{x:.2f}' for x in r['close_latency_ms'])}), "
            f"{r['windows_checked']} windows checked, launches "
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
