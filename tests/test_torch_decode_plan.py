"""The host-side plans and arithmetic of the wire decode (csrc/decode.cu)
and the top-k fold (csrc/topk.cu):

* lattice.divisor's multipliers, through a numpy model of the kernels'
  floor division (record.cuh fdiv), against Python's // and %, and the
  top-k kernel's window slots (window_slot) against the plain step's;
* lattice.topk_plan's choice between the block-private and the global
  branch, and its grid;
* transport.decode_plan's grid and tiles, and numpy models of the
  decode's four values a thread (unpack4: the words it loads, the values
  it gives) and of its one-pass delta scan (per-block sums mod 2^32, a
  look-back over the earlier blocks), held against the plain decode."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from hstream_tpu_torch.engine import lattice
from hstream_tpu_torch.engine import transport as tp
from hstream_tpu_torch.engine.kernels import binding as kb

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def fdiv_model(a: np.ndarray, d: int) -> np.ndarray:
    """record.cuh fdiv on int64 copies of int32 values: x = a ^ (a >> 31),
    q = (x * m) >> shift in 64-bit unsigned arithmetic, ~q for a < 0."""
    m, shift = lattice.divisor(d)
    a = a.astype(np.int64)
    x = (a ^ (a >> 31)).astype(np.uint64)
    q = ((x * np.uint64(m)) >> np.uint64(shift)).astype(np.int64)
    return np.where(a < 0, ~q, q)


EDGE_T = np.array([I32_MIN, I32_MIN + 1, -(1 << 30), -10_001, -10_000,
                   -9_999, -2, -1, 0, 1, 2, 9_999, 10_000, 10_001,
                   1 << 30, I32_MAX - 1, I32_MAX], np.int64)
EDGE_D = [1, 2, 3, 5, 7, 10, 1000, 10_000, 60_000, 86_400_000,
          (1 << 16) + 1, (1 << 30) - 1, 1 << 30, (1 << 30) + 1,
          (1 << 31) - 3, (1 << 31) - 1]


@pytest.mark.parametrize("d", EDGE_D)
def test_fdiv_is_floor_division_at_the_edges(d):
    rng = np.random.default_rng(d % 1000)
    t = np.concatenate([EDGE_T, rng.integers(I32_MIN, I32_MAX, 20_000,
                                             endpoint=True),
                        np.arange(-3 * d, 3 * d + 1, max(1, d // 7))
                        .clip(I32_MIN, I32_MAX)])
    q = fdiv_model(t, d)
    assert [int(x) for x in q] == [int(x) // d for x in t]
    mod = t - q * d
    assert [int(x) for x in mod] == [int(x) % d for x in t]


def test_fdiv_over_random_divisors():
    rng = np.random.default_rng(7)
    for d in rng.integers(1, 1 << 31, 200):
        d = int(d)
        m, shift = lattice.divisor(d)
        assert 0 < m < 1 << 32 and 31 <= shift <= 62
        t = rng.integers(I32_MIN, I32_MAX, 2_000, endpoint=True)
        t[:len(EDGE_T)] = EDGE_T
        assert np.array_equal(fdiv_model(t, d), np.floor_divide(t, d))


def test_divisor_refuses_what_the_kernel_cannot_take():
    for d in (0, -1, 1 << 31):
        with pytest.raises(ValueError, match="divisor"):
            lattice.divisor(d)


def window_slot_model(spec, t: np.ndarray, j: int, watermark: int):
    """record.cuh window_slot over int32 timestamps: (in range, slot)."""
    win = spec.window
    adv = win.advance_ms
    u32 = np.uint64(0xFFFFFFFF)

    def i32(x):
        x = x.astype(np.int64) & 0xFFFFFFFF
        return np.where(x >= 1 << 31, x - (1 << 32), x)

    latest = (fdiv_model(t, adv).astype(np.uint64) * np.uint64(adv)) & u32
    start = i32(latest.astype(np.int64) - j * adv)
    end = i32(start + win.size_ms + win.grace_ms)
    ok = ~(end <= watermark) & (start >= 0)
    q = fdiv_model(np.where(ok, start, 0), adv)
    slot = q - fdiv_model(q, spec.n_slots) * spec.n_slots
    return ok, slot


@pytest.mark.parametrize("cfg", [1, 2])
def test_window_slot_model_matches_the_plain_step(cfg):
    """The top-k kernel's windows (config 1's tumbling, config 2's six
    hopping windows a record) equal the plain step's masks and slots,
    over negative, wrapping and large timestamps."""
    spec = chip_smoke.make_spec(cfg)
    rng = np.random.default_rng(cfg)
    t = np.concatenate([EDGE_T, rng.integers(I32_MIN, I32_MAX, 5_000,
                                             endpoint=True),
                        rng.integers(-200_000, 400_000, 5_000)])
    n = t.shape[0]
    for wm in (-1, 90_000):
        starts, slots, ok_slot, _, _ = lattice._record_cells(
            spec, wm, torch.zeros(n, dtype=torch.int32),
            torch.from_numpy(t.astype(np.int32)),
            torch.ones(n, dtype=torch.bool))
        for j in range(spec.windows_per_record):
            ok, slot = window_slot_model(spec, t, j, wm)
            assert np.array_equal(ok, ok_slot[:, j].numpy())
            assert np.array_equal(slot[ok], slots[:, j].numpy()[ok])


# ---- the top-k plan ----------------------------------------------------------

def test_topk_plan_per_lattice():
    """Config 1 (no TOPK: only the lock and list words), the changelog
    query (two TOPK planes at k = 3: 120 KB), chip_smoke's four-plane
    check lattice (168 KB) take the block-private branch, 1024-thread
    blocks; 2^16 keys do not fit and take the global one, 256-thread
    blocks; nor does a k past 32, the bits of a cell's mask. Per cell: a
    lock word, a list entry, a mask word an aggregate, k values an
    aggregate; and the list's count, each part padded to 16 bytes."""
    _, _, cspec, _ = chip_smoke.changelog_plan()
    cells = 1024 * 3
    cases = {"config 1": (chip_smoke.make_spec(1), 4 * (2 * cells + 4)),
             "changelog": (cspec, 4 * (4 * cells + 4 + 2 * 3 * cells)),
             "check": (chip_smoke.topk_spec(),
                       4 * (6 * cells + 4 + 8 * cells)),
             "2^16 keys": (chip_smoke.topk_spec(1 << 16),
                           4 * (6 * 64 * cells + 4 + 8 * 64 * cells))}
    for name, (spec, smem) in cases.items():
        assert spec.n_slots == 3, name
        assert lattice.topk_smem_bytes(spec) == smem, name
        plan = lattice.topk_plan(spec, 1 << 20)
        if smem <= lattice.TOPK_SMEM_LIMIT:
            assert plan == (kb.TOPK_PRIVATE, 132), name
        else:
            # four records a thread: 1024 blocks, fewer than 8 an SM
            assert plan == (kb.TOPK_GLOBAL, 1024), name
            with pytest.raises(ValueError, match="shared memory"):
                lattice.topk_plan(spec, 1 << 20, mode=kb.TOPK_PRIVATE)
    assert lattice.TOPK_SMEM_LIMIT == 227 * 1024
    wide = lattice.LatticeSpec(
        n_keys=8, window=chip_smoke.topk_spec().window,
        aggs=(dataclasses.replace(chip_smoke.topk_spec().aggs[0], k=33),))
    assert lattice.topk_smem_bytes(wide) < lattice.TOPK_SMEM_LIMIT
    assert lattice.topk_plan(wide, 1 << 20).mode == kb.TOPK_GLOBAL
    with pytest.raises(ValueError, match="shared memory"):
        lattice.topk_plan(wide, 1 << 20, mode=kb.TOPK_PRIVATE)


def test_topk_grid_is_no_larger_than_the_batch_needs():
    spec = chip_smoke.topk_spec()
    per_block = kb.TOPK_PRIVATE_THREADS * kb.TOPK_PER
    assert lattice.topk_plan(spec, 1).blocks == 1
    assert lattice.topk_plan(spec, per_block).blocks == 1
    assert lattice.topk_plan(spec, per_block + 1).blocks == 2
    assert lattice.topk_plan(spec, 1 << 30, n_sms=8).blocks == 8
    g = lattice.topk_plan(spec, 10 * kb.TOPK_GLOBAL_THREADS * kb.TOPK_PER,
                          mode=kb.TOPK_GLOBAL)
    assert g == (kb.TOPK_GLOBAL, 10)


@pytest.mark.parametrize("forced", [None, kb.TOPK_PRIVATE, kb.TOPK_GLOBAL])
def test_topk_step_on_cpu_tensors_runs_the_plain_version(forced):
    """Whatever the branch asked for, CPU tensors take the plain fold."""
    spec = chip_smoke.topk_spec()
    key, ts, valid, cols = chip_smoke.topk_inputs(torch.device("cpu"), 3)
    a = lattice.init_state(spec, "cpu")
    b = lattice.init_state(spec, "cpu")
    lattice.topk_step(spec, a, 205_000, key, ts, valid, cols, mode=forced)
    lattice.topk_step_ref(spec, b, 205_000, key, ts, valid, cols)
    for k in a:
        assert chip_smoke.same_bits(a[k], b[k]), k


# ---- the decode plan and models --------------------------------------------

@pytest.mark.parametrize("cap", [1, 3, 1023, 1024, 1025, (1 << 20) - 333,
                                 1 << 20, 3 << 20, 1 << 24])
def test_decode_plan_covers_every_tile_once_in_one_wave(cap):
    blocks, per, _ = tp.decode_plan(cap)
    tiles = -(-cap // tp.DECODE_TILE)
    assert tp.DECODE_TILE == 1024 == kb.DECODE_THREADS * kb.DECODE_PER
    assert blocks * per >= tiles > (blocks - 1) * per   # none idle
    assert blocks <= tp.DECODE_BLOCKS_PER_SM * tp.H100_SMS
    assert per == -(-tiles // (tp.DECODE_BLOCKS_PER_SM * tp.H100_SMS))


def test_decode_plan_at_the_path_shapes():
    """Grids at the paths' batch sizes; the delta stream takes four of a
    block's warps on the headline wire (keys and temps besides it) and
    two on the changelog's (keys, temps and five NULL masks)."""
    assert tp.decode_plan(1 << 20) == (512, 2, 4)
    assert tp.decode_plan(3 << 20) == (512, 6, 4)
    assert tp.decode_plan(1 << 16) == (64, 1, 4)
    assert tp.decode_plan(1 << 20, n_sms=8) == (32, 32, 4)
    assert tp.decode_plan(1 << 20, columns=7).delta_warps == 2
    assert tp.decode_plan(1 << 20, columns=3).delta_warps == 2


def unpack4_model(words: list, i: int, bits: int, lim: int, touched: set):
    """decode.cu unpack4: values i .. i+3 (lim of them) of a `bits`-wide
    stream through a 64-bit window refilled a word at a time; every
    word index it loads goes into `touched`."""
    if bits == 0:
        return [0] * 4
    pos = i * bits
    w0, sh = pos >> 5, pos & 31
    touched |= {w0, w0 + 1}
    buf = (words[w0] | words[w0 + 1] << 32) >> sh
    have, nxt = 64 - sh, 2
    mask = (1 << bits) - 1
    out = []
    for k in range(4):
        if k < lim and have < bits:
            touched.add(w0 + nxt)
            buf |= words[w0 + nxt] << have
            nxt += 1
            have += 32
        out.append(buf & mask if k < lim else 0)
        buf = (buf >> bits) & ((1 << 64) - 1)
        have -= bits
    return out


@pytest.mark.parametrize("bits", sorted(set(tp._BIT_LADDER) | {7, 31}))
@pytest.mark.parametrize("cap", [1, 5, 31, 33, 1023, 4097])
def test_unpack4_model_is_the_plain_decode_in_bounds(bits, cap):
    """Four values a thread give the plain decode's values, and no load
    passes the stream's pad word."""
    rng = np.random.default_rng(bits * 10_000 + cap)
    plan = tp.StreamPlan("x", tp.ENC_BP, bits=bits)
    nw = plan.words(cap)
    words = rng.integers(0, 1 << 32, nw, dtype=np.uint64)
    want = tp._bp_decode_ref(torch.from_numpy(words.astype(np.int64)),
                             bits, cap).numpy()
    w = [int(x) for x in words]
    touched: set = set()
    got = []
    for i in range(0, cap, 4):
        got += unpack4_model(w, i, bits, min(4, cap - i), touched)[
            :min(4, cap - i)]
    assert got == [int(x) for x in want]
    assert not touched or max(touched) < nw


def delta_scan_model(u: np.ndarray, base: int, cap: int, n_sms: int):
    """decode.cu's delta stream: each block of decode_plan sums its
    deltas mod 2^32 and publishes the sum (here the blocks run in a
    random order); a block's prefix is base plus its predecessors' sums
    (the look-back), then its own running scan."""
    blocks, per, _ = tp.decode_plan(cap, n_sms)
    span = per * tp.DECODE_TILE
    sums = [int(u[b * span:(b + 1) * span].sum()) & 0xFFFFFFFF
            for b in range(blocks)]
    out = np.zeros(cap, np.int64)
    order = np.random.default_rng(cap).permutation(blocks)
    for b in order:   # any order: a block reads only published sums
        prefix = (base + sum(sums[:b])) & 0xFFFFFFFF
        seg = u[b * span:(b + 1) * span]
        out[b * span:b * span + seg.shape[0]] = (
            prefix + np.cumsum(seg)) & 0xFFFFFFFF
    return np.where(out >= 1 << 31, out - (1 << 32), out).astype(np.int32)


@pytest.mark.parametrize("cap,n_sms", [(1, 132), (1023, 132),
                                       (3 << 16, 2), (300_001, 132),
                                       (3 << 20, 1)])
def test_delta_scan_model_is_the_plain_cumsum(cap, n_sms):
    """With 32-bit deltas the running sum wraps past 2^32 many times;
    the one-pass scan equals decode_batch_ref's."""
    rng = np.random.default_rng(cap)
    plan = tp.StreamPlan("__dt", tp.ENC_BPD, bits=32)
    words = rng.integers(I32_MIN, I32_MAX, plan.words(cap), endpoint=True)
    base = int(rng.integers(I32_MIN, I32_MAX))
    want = tp._unpack_stream_ref(plan, torch.from_numpy(
        words.astype(np.int32)), cap, base).numpy()
    u = words[:cap].astype(np.int64) & 0xFFFFFFFF
    assert np.array_equal(delta_scan_model(u, base, cap, n_sms), want)
