#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hstream_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero):

1. card: the card's name and power limit, torch and CUDA versions;
2. build: the kernels from engine/kernels/csrc (one nvcc per source,
   all started together);
3. kernels vs plain: every kernel against its plain PyTorch version on
   the same inputs on the card, and timed at the main path's shapes
   beside its plain version, its bound and, where one exists, PyTorch
   calls computing the same function;
4. main path, config 1 (BASELINE 1/3): COUNT(*), SUM(temp),
   APPROX_COUNT_DISTINCT(temp) GROUP BY device, TUMBLE(10s) over 1000
   keys, 2^20-record batches through IngestPipeline past two window
   closes, checked against a numpy reference; then close-latency
   samples, the first of which rebases the epoch;
5. main path, config 2 (BASELINE 2): HOP(60s,10s) AVG/MIN/MAX over 1000
   keys, the same way;
6. a {"kernels": [...]} line (each kernel's launches on the main paths,
   its error against the plain version and its times), the card line,
   and last {"ok": true, "device": {...}}.

Inputs come from fixed seeds with numpy. Tolerances: integer planes,
slot_start, HLL registers and estimates, MIN/MAX, counts and every
packed close row are exact. SUM/AVG accumulators add with float atomics
in an order that changes from run to run; two summation orders of n
terms differ by at most 2*n*2^-24*sum|x|, the bound each SUM cell (and
each AVG cell's sum) is held to. Details go to smoke_out/chip_smoke.json.
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


def launch_counts() -> dict[str, int]:
    from hstream_tpu_torch.engine import lattice, transport

    return {"wire_decode": transport.decode_batch.launches,
            "scatter_aggregate": lattice.scatter_step.launches,
            "fused_close": lattice.close_slots.launches,
            "rebase": lattice.rebase.launches}


def zero_counts() -> None:
    from hstream_tpu_torch.engine import lattice, transport

    transport.decode_batch.launches = 0
    lattice.scatter_step.launches = 0
    lattice.close_slots.launches = 0
    lattice.rebase.launches = 0


# ---- the two configurations ---------------------------------------------------

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


# ---- numpy reference (independent of the port) ---------------------------------

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


# ---- phase 3: kernels against their plain versions -----------------------------

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
    ms = cuda_time_ms(lambda: tp.decode_batch(w, combo, BATCH, BATCH,
                                              bases), 50)
    plain = cuda_time_ms(lambda: tp.decode_batch_ref(w, combo, BATCH, BATCH,
                                                     bases), 5)
    nbytes = w.numel() * 4 + BATCH * (4 + 4 + 1 + 4)
    b_ms, b_by = bound(nbytes, BATCH * len(combo) * 8)
    results["wire_decode"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/decode.cu",
        replaces="hstream_tpu/engine/transport.py:197",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, wire_bytes_per_event=w.numel() * 4
        / BATCH)
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
    ms = cuda_time_ms(lambda: lattice.scatter_step(
        spec, st, wm, key, ts, valid, cols), 30)
    plain = cuda_time_ms(lambda: lattice.scatter_step_ref(
        spec, st, wm, key, ts, valid, cols), 3)
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

    lib_ms = cuda_time_ms(library, 30)
    # config 2's lattice on the same records, at its epoch offset (its
    # epoch sits 110 s before the first record): six windows each
    spec2 = make_spec(2)
    st2 = lattice.init_state(spec2, dev)
    ts2 = ts + 100_000
    lattice.scatter_step(spec2, st2, wm, key, ts2, valid, cols)
    assert int(st2["count"].sum()) == 6 * BATCH
    ms2 = cuda_time_ms(lambda: lattice.scatter_step(
        spec2, st2, wm, key, ts2, valid, cols), 30)
    slots_hit = int(torch.unique(slot).numel())
    planes = spec.n_keys * slots_hit * (4 + 4 + 1024)  # count, sum, HLL
    nbytes = BATCH * (4 + 4 + 1 + 4) + 2 * planes
    b_ms, b_by = bound(nbytes, BATCH * 40)
    results["scatter_aggregate"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/scatter.cu",
        replaces="hstream_tpu/engine/lattice.py:138",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, ms_config2=ms2)
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
    ms = cuda_time_ms(lambda: lattice.close_slots(spec, st, slots), 50)

    def plain_close():
        lattice.extract_slots_ref(spec, st, slots_t)
        lattice.reset_slots_ref(spec, st, slots_t)

    plain = cuda_time_ms(plain_close, 5)
    rows = 2 + len(spec.aggs)
    cells = spec.n_keys * (4 + 4 + 1024)      # one slot: count, sum, HLL
    b_ms, b_by = bound(2 * cells + rows * spec.n_keys * 4,
                       spec.n_keys * 1024 * 4)
    results["fused_close"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/close.cu",
        replaces="hstream_tpu/engine/lattice.py:624",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"fused_close: {len(cases)} cases (3 modes) bit-exact; {ms:.4f} ms "
        f"(plain {plain:.4f}, bound {b_ms:.4f})")


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
    ms = cuda_time_ms(lambda: lattice.rebase(st, 0), 200)
    plain = cuda_time_ms(lambda: lattice.rebase_ref(st, 0), 200)
    b_ms, b_by = bound(2 * 3 * 4, 3)
    results["rebase"] = dict(
        route="cuda",
        source="hstream_tpu_torch/engine/kernels/csrc/rebase.cu",
        replaces="hstream_tpu/engine/lattice.py:1571",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"rebase: exact; {ms:.4f} ms (plain {plain:.4f}, bound "
        f"{b_ms:.6f})")


# ---- phases 4-5: the main path ------------------------------------------------

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
    ex = QueryExecutor(node, schema, initial_keys=1024,
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
    assert all(v > 0 for v in counts.values()), counts
    eps = MAIN_BATCHES * BATCH / wall
    return dict(config=cfg, events_per_sec=eps, wall_s=wall,
                windows_checked=n_windows, rows=len(rows),
                close_stats=ex.close_stats, launches=counts,
                close_latency_ms=latency,
                close_latency_ms_median=float(np.median(latency)),
                transfer_stats=ex.transfer_stats, pipeline_stages=stages)


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
