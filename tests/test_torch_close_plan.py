"""The host-side plans and the lane layouts of the redesigned close
(csrc/close.cu) and session extract (csrc/session_extract.cu), as numpy
models, with no card:

  * lattice.close_plan: a warp a key where a close finalizes a sketch or
    resets a cell of 256 bytes or more, else a thread, for every lattice
    the window paths step, in each mode;
  * close.cu's grid (a model of its launch()): every (slot, key) of a
    close taken by exactly `lanes` threads, K a multiple of the tile or
    not;
  * finalize.cuh's reads: an HLL plane's registers each read once by the
    16-byte vectors lanes take (p 2 to 16), and the quantile scan (rounds
    of 128 bins, four consecutive bins a lane, a warp scan a round with a
    running carry, several quantiles at once) giving the plain
    sketches.quantile_estimate's bin on histograms of 512, 1024 and 100
    bins, empty ones among them; its fast path (the round from the
    rounds' totals, the lane from a ballot, then the lane's bins) giving
    the scan's bin;
  * the session extract's grouping: every APPROX_QUANTILE answered once,
    by the pass of the first aggregate that reads its histogram, at most
    four a pass.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from hstream_tpu_torch.engine import lattice
from hstream_tpu_torch.engine import session_lattice as sl
from hstream_tpu_torch.engine.expr import Col
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.plan import AggKind, AggSpec
from hstream_tpu_torch.engine.sketches import (HLLConfig, QuantileConfig,
                                               quantile_estimate)
from hstream_tpu_torch.engine.window import TumblingWindow

MODES = (lattice.CLOSE_EXTRACT_RESET, lattice.CLOSE_EXTRACT,
         lattice.CLOSE_RESET)
# lanes a key in (extract+reset, extract, reset)
LANES = {"config 1": (32, 32, 32), "config 2": (1, 1, 1),
         "changelog": (32, 32, 32), "log": (1, 1, 1),
         "sketch kinds": (32, 32, 32), "int and bool": (1, 1, 1),
         "join inner": (1, 1, 1)}


@pytest.fixture(scope="module")
def specs():
    return chip_smoke.scatter_specs()


@pytest.mark.parametrize("name", sorted(LANES))
def test_close_plan_gives_a_warp_to_sketches_and_wide_cells(specs, name):
    spec = specs[name]
    assert tuple(lattice.close_plan(spec, m) for m in MODES) == LANES[name]


@pytest.mark.parametrize("p", [4, 6, 10, 14])
def test_a_small_hll_plane_resets_a_key_a_thread(p):
    """HLL's 2^p registers: a warp finalizes the estimate; a reset-only
    close takes a warp a key only from 256-byte cells (p >= 8)."""
    spec = lattice.LatticeSpec(
        n_keys=8, window=TumblingWindow(10_000, grace_ms=0),
        aggs=(AggSpec(AggKind.APPROX_COUNT_DISTINCT, "u", input=Col("x")),),
        hll=HLLConfig(p))
    assert lattice.close_cell_bytes(spec) == 1 << p
    assert lattice.close_plan(spec, lattice.CLOSE_EXTRACT) == 32
    assert lattice.close_plan(spec, lattice.CLOSE_RESET) == \
        (32 if (1 << p) >= 256 else 1)


def close_grid(n_keys: int, n_sel: int, lanes: int) -> tuple[int, int]:
    """close.cu's launch(): (key tiles of THREADS / lanes keys, slots),
    at least one tile (hs_close_slot resets slot_start with no keys)."""
    keys = kb.CLOSE_THREADS // lanes
    return max(1, -(-n_keys // keys)), n_sel


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("n_keys", [1, 7, 8, 9, 255, 256, 257, 1000, 1024])
def test_close_grid_takes_every_key_of_every_slot_once(lanes, n_keys):
    """close.cu's mapping: block (x, y), thread t -> slot y, key
    x * (THREADS / lanes) + t / lanes, lane t % lanes; threads past K
    idle."""
    for n_sel in (1, 3):
        gx, gy = close_grid(n_keys, n_sel, lanes)
        assert gy == n_sel
        keys = kb.CLOSE_THREADS // lanes
        t = np.arange(kb.CLOSE_THREADS)
        k = (np.arange(gx)[:, None] * keys + t[None, :] // lanes).ravel()
        lane = np.tile(t % lanes, gx)
        live = k < n_keys
        pairs = k[live] * lanes + lane[live]
        assert np.array_equal(np.sort(pairs), np.arange(n_keys * lanes))
        assert gx == -(-n_keys // keys)   # no tile without a key


def test_close_grid_has_a_tile_for_a_slot_without_keys():
    """hs_close_slot's reset of slot_start needs one block even at K=0."""
    assert close_grid(0, 1, 1) == (1, 1)


@pytest.mark.parametrize("p", range(2, 17))
def test_hll_lanes_read_every_register_once(p):
    """hll_warp: 16-byte vectors w = w0 + 32 u + lane (u < 4, w0 a
    multiple of 128) below m / 16, or 32-bit words below p = 4."""
    m = 1 << p
    seen = np.zeros(m, np.int64)
    for lane in range(32):
        if m >= 16:
            nv = m >> 4
            for w0 in range(0, nv, 128):
                for u in range(4):
                    w = w0 + 32 * u + lane
                    if w < nv:
                        seen[16 * w:16 * w + 16] += 1
        else:
            for w in range(lane, m >> 2, 32):
                seen[4 * w:4 * w + 4] += 1
    assert (seen == 1).all()


def quant_scan_model(h: np.ndarray, qs: list[float]) -> tuple[int, list]:
    """finalize.cuh quant_scan, lane by lane: (total, [bin index a
    quantile names])."""
    bins = len(h)
    rounds = -(-bins // 128)
    total = int(h.astype(np.int64).sum())
    tf = np.float32(max(np.float32(total), np.float32(1.0)))
    target = [np.float32(np.float32(q) * tf) for q in qs]
    below = [0] * len(qs)
    carry = 0
    for i in range(rounds):
        v = np.zeros((32, 4), np.int64)
        for lane in range(32):
            for j in range(4):
                b = i * 128 + lane * 4 + j
                if b < bins:
                    v[lane, j] = h[b]
        s = v.sum(1)
        incl = np.cumsum(s)
        for lane in range(32):
            cdf = carry + incl[lane] - s[lane]
            for j in range(4):
                cdf += v[lane, j]
                b = i * 128 + lane * 4 + j
                for k, t in enumerate(target):
                    below[k] += b < bins and np.float32(cdf) < t
        carry += int(incl[31])
    return total, [min(max(x, 0), bins - 1) for x in below]


def quant_search_model(h: np.ndarray, qs: list[float]) -> list:
    """finalize.cuh quant_scan_t's fast path (whole rounds, at most four,
    a total of at most 2^24): per quantile x = ceil(target); the rounds
    whose end lies below x, then in the next round the lanes whose four
    bins all lie below it (a ballot over one scan), then the crossing
    lane's bins."""
    bins = len(h)
    rounds = bins // 128
    v = np.zeros((4, 32, 4), np.int64)
    v[:rounds] = h.reshape(rounds, 32, 4)
    total = int(h.sum())
    assert bins % 128 == 0 and rounds <= 4 and total <= 1 << 24
    tf = np.float32(max(np.float32(total), np.float32(1.0)))
    sums = v.sum(2)                      # [round, lane]
    end = np.cumsum(sums.sum(1))         # per round
    out = []
    for q in qs:
        x = int(np.ceil(np.float32(np.float32(q) * tf)))
        r = int((end < x).sum())
        b = bins
        if r < rounds:
            start = int(end[r - 1]) if r > 0 else 0
            incl = np.cumsum(sums[r])
            whole = int((start + incl < x).sum())
            c0 = start + int(incl[whole] - sums[r, whole]) + \
                int(v[r, whole, 0])
            w1, w2 = int(v[r, whole, 1]), int(v[r, whole, 2])
            b = 128 * r + 4 * whole + (c0 < x) + (c0 + w1 < x) + \
                (c0 + w1 + w2 < x)
        out.append(min(max(b, 0), bins - 1))
    return out


@pytest.mark.parametrize("bins", [512, 256, 128])
def test_quantile_search_names_the_bin_the_scan_does(bins):
    """The fast path's bin equals the per-bin scan's on empty, sparse,
    dense and one-spike histograms, at q 0.5, 0.99, 1, 1e-30 and 0."""
    rng = np.random.default_rng(bins + 1)
    qs = [0.5, 0.99, 1.0, 1e-30, 0.0]
    hists = [np.zeros(bins, np.int32),
             rng.integers(0, 5, bins).astype(np.int32),
             np.where(rng.random(bins) < 0.05,
                      rng.integers(0, 1 << 12, bins), 0).astype(np.int32)]
    spike = np.zeros(bins, np.int32)
    spike[rng.integers(0, bins)] = 1 << 22
    hists.append(spike)
    for h in hists:
        assert quant_search_model(h, qs) == quant_scan_model(h, qs)[1]


@pytest.mark.parametrize("bins", [512, 1024, 100])
def test_quantile_scan_names_the_plain_versions_bin(bins):
    cfg = QuantileConfig(n_bins=bins)
    rng = np.random.default_rng(bins)
    qs = [0.5, 0.99, 1.0, 1e-30]
    hists = [np.zeros(bins, np.int32),
             rng.integers(0, 5, bins).astype(np.int32),
             np.where(rng.random(bins) < 0.05,
                      rng.integers(0, 1 << 20, bins), 0).astype(np.int32)]
    for h in hists:
        total, idx = quant_scan_model(h, qs)
        assert total == int(h.sum())
        t = torch.from_numpy(h)
        for q, i in zip(qs, idx):
            want = quantile_estimate(t, q, cfg)
            log_lo = (np.float32(i) - np.float32(1.0)) * \
                np.float32(cfg.gamma_log)
            got = np.float32(0.0) if i == 0 else np.float32(
                np.float32(cfg.min_value) * np.exp(
                    log_lo + np.float32(0.5 * cfg.gamma_log),
                    dtype=np.float32))
            assert got == pytest.approx(float(want), rel=2e-6), (q, i)


def quantile_passes(kinds: list[str], planes: list[str]) -> list[list[int]]:
    """session_extract.cu's quantile loops: for each aggregate g that is
    the first QUANT of its plane, passes of at most four of the QUANT
    aggregates that share it, in order."""
    passes = []
    for g, (kind, plane) in enumerate(zip(kinds, planes)):
        if kind != "QUANT":
            continue
        if any(kinds[j] == "QUANT" and planes[j] == plane
               for j in range(g)):
            continue
        h0 = g
        while h0 < len(kinds):
            who, nxt = [], len(kinds)
            for j in range(h0, len(kinds)):
                if kinds[j] != "QUANT" or planes[j] != plane:
                    continue
                if len(who) == 4:
                    nxt = j
                    break
                who.append(j)
            passes.append(who)
            h0 = nxt
    return passes


def test_every_session_quantile_is_answered_once_from_its_histogram():
    """Nine quantiles of one column (three passes over its histogram),
    two of another, among other aggregates: each answered once, by the
    plane it reads."""
    x, y = Col("x"), Col("y")
    aggs = [AggSpec(AggKind.COUNT_ALL, "c")]
    aggs += [AggSpec(AggKind.APPROX_QUANTILE, f"qx{k}", input=x,
                     quantile=k / 10) for k in range(1, 6)]
    aggs += [AggSpec(AggKind.SUM, "s", input=x),
             AggSpec(AggKind.APPROX_QUANTILE, "qy1", input=y, quantile=0.5)]
    aggs += [AggSpec(AggKind.APPROX_QUANTILE, f"qx{k}", input=x,
                     quantile=k / 10) for k in range(6, 10)]
    aggs += [AggSpec(AggKind.APPROX_QUANTILE, "qy2", input=y, quantile=0.9),
             AggSpec(AggKind.APPROX_COUNT_DISTINCT, "d", input=x)]
    spec = sl.SessionSpec(aggs=tuple(aggs))
    planes = sl.session_plane_names(spec)
    kinds = ["QUANT" if a.kind == AggKind.APPROX_QUANTILE else "other"
             for a in aggs]
    passes = quantile_passes(kinds, planes)
    answered = sorted(j for p in passes for j in p)
    assert answered == [g for g, k in enumerate(kinds) if k == "QUANT"]
    assert all(len(p) <= 4 and len({planes[j] for j in p}) == 1
               for p in passes)
    assert len(passes) == 3 + 1   # x: 4 + 4 + 1, y: 2
