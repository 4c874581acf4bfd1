"""The host-side plans that pick the kernels' branches: the scatter's
(lattice.scatter_plan: block-private when the [K, W] planes fit in a
block's shared memory, else global atomics) and the touched extract's
(lattice.touched_plan: one launch for a lattice of at most 4096 cells,
else staged); a numpy model of the touched extract's one-pass compaction
(tiles of 4096 flags, offsets from a decoupled look-back) held against
jnp.nonzero's order with max_out truncation, and of the look-back past
32 rounds of status words; and the wrappers' CPU path,
which runs the plain version whatever the plan."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from hstream_tpu_torch.engine import lattice
from hstream_tpu_torch.engine.expr import Col
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.plan import AggKind, AggSpec
from hstream_tpu_torch.engine.window import TumblingWindow

BATCH = 1 << 20
PRIVATE, CLUSTER, GLOBAL = (kb.SCATTER_PRIVATE, kb.SCATTER_CLUSTER,
                            kb.SCATTER_GLOBAL)

# every spec the port's window paths step: its branch and the shared
# memory of a block in the block-private branches (4 B per [K, W] cell
# of count and each COUNT, SUM, AVG (two), MIN and MAX plane, plus
# slot_start [W])
SPECS = {
    "config 1": (PRIVATE, 4 * (1024 * 3 * 2 + 3)),
    "config 2": (CLUSTER, 4 * (1024 * 8 * 5 + 8)),
    "changelog": (PRIVATE, 4 * (1024 * 3 * 3 + 3)),
    "log": (PRIVATE, 4 * (1024 * 3 * 6 + 3)),
    "sketch kinds": (PRIVATE, 4 * (1024 * 3 * 7 + 3)),
    "int and bool": (PRIVATE, 4 * (1024 * 3 * 9 + 3)),
    "join inner": (GLOBAL, 4 * ((1 << 19) * 3 * 1 + 3)),
}


@pytest.fixture(scope="module")
def specs():
    return chip_smoke.scatter_specs()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_every_path_spec_takes_its_branch(specs, name):
    mode, smem = SPECS[name]
    plan = lattice.scatter_plan(specs[name], BATCH)
    assert plan.mode == mode
    assert lattice.scatter_smem_bytes(specs[name]) == smem
    if mode != GLOBAL:
        assert smem <= lattice.SCATTER_SMEM_LIMIT < 227 * 1024
        # clusters where a record's pane fans out to several windows
        assert (mode == CLUSTER) == (specs[name].windows_per_record > 1)
    else:
        assert smem > lattice.SCATTER_SMEM_LIMIT
        with pytest.raises(ValueError, match="shared memory"):
            lattice.scatter_plan(specs[name], BATCH, mode=PRIVATE)


def test_grid_is_one_or_two_blocks_an_sm_and_2048_records_a_block(specs):
    # config 1's 24 KB: two blocks an SM; config 2's 160 KB: one, in
    # whole clusters of 8 blocks
    assert lattice.SCATTER_CLUSTER == 8
    assert lattice.scatter_plan(specs["config 1"], BATCH).blocks == 264
    assert lattice.scatter_plan(specs["config 2"], BATCH).blocks == 128
    assert lattice.scatter_plan(specs["config 2"], BATCH, n_sms=114) \
        .blocks == 112
    for cap, blocks in ((1, 1), (2048, 1), (2049, 2), (4096, 2),
                        (1 << 16, 32)):
        assert lattice.scatter_plan(specs["config 1"], cap).blocks == blocks
    for cap, blocks in ((1, 8), (16_384, 8), (20_480, 8), (32_768, 16),
                        (1 << 16, 32)):
        assert lattice.scatter_plan(specs["config 2"], cap).blocks == blocks
    # global: one thread per (record, window), 256 threads a block
    assert lattice.scatter_plan(specs["join inner"], 1 << 21).blocks == 8192
    assert lattice.scatter_plan(specs["join inner"], 5).blocks == 1
    assert lattice.scatter_plan(specs["config 2"], BATCH,
                                mode=GLOBAL).blocks == 6 * BATCH // 256


def _sum_spec(n_keys: int) -> lattice.LatticeSpec:
    return lattice.LatticeSpec(
        n_keys=n_keys, window=TumblingWindow(10_000, grace_ms=0),
        aggs=(AggSpec(AggKind.COUNT_ALL, "c"),
              AggSpec(AggKind.SUM, "s", input=Col("x"))))


@pytest.mark.parametrize("extra_keys, mode", [(0, PRIVATE), (1, GLOBAL)])
def test_a_spec_just_over_the_shared_memory_limit_goes_global(extra_keys,
                                                              mode):
    # COUNT(*) and SUM: two [K, W] planes and W slot starts; the largest
    # K that fits the limit, then one key more
    limit_words = lattice.SCATTER_SMEM_LIMIT // 4
    W = _sum_spec(1).n_slots
    K = (limit_words - W) // (2 * W)
    used = 2 * K * W + W
    assert used <= limit_words < used + 2 * W
    spec = _sum_spec(K + extra_keys)
    assert lattice.scatter_plan(spec, BATCH).mode == mode
    smem = lattice.scatter_smem_bytes(spec)
    if mode == PRIVATE:
        assert smem == 4 * used <= lattice.SCATTER_SMEM_LIMIT
    else:
        assert smem == 4 * (used + 2 * W) > lattice.SCATTER_SMEM_LIMIT


def test_hll_and_quantile_planes_stay_global(specs):
    # K2's HLL registers (3 MiB) and bins are not in shared memory; its
    # count, COUNT, SUM, AVG (two), MIN, MAX are
    assert lattice.scatter_plan(specs["sketch kinds"], BATCH).mode == PRIVATE
    assert lattice.scatter_smem_bytes(specs["sketch kinds"]) \
        == 4 * (1024 * 3 * 7 + 3)


def test_private_false_forces_the_global_branch(specs):
    # the one override the checks use: `mode`, here the global branch
    for name in SPECS:
        plan = lattice.scatter_plan(specs[name], BATCH, mode=GLOBAL)
        per = specs[name].windows_per_record
        assert plan == lattice.ScatterPlan(GLOBAL, BATCH * per // 256)


def _cpu_batch(spec, n: int, seed: int):
    rng = np.random.default_rng(seed)
    key = torch.from_numpy(rng.integers(-2, spec.n_keys + 2, n)
                           .astype(np.int32))
    ts = torch.from_numpy(rng.integers(0, 40_000, n).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) > 0.05)
    cols = {name: torch.from_numpy(rng.normal(20, 5, n).astype(np.float32))
            for name in lattice.agg_input_columns(spec) if name is not None}
    return key, ts, valid, cols


@pytest.mark.parametrize("forced", [False, True])
def test_scatter_step_on_cpu_tensors_runs_the_plain_version(specs, forced,
                                                            monkeypatch):
    spec = specs["config 2"]
    key, ts, valid, cols = _cpu_batch(spec, 4096, 3)
    calls = []
    ref = lattice.scatter_step_ref

    def recording(*a, **k):
        calls.append(a[0])
        return ref(*a, **k)

    monkeypatch.setattr(lattice, "scatter_step_ref", recording)
    got = lattice.init_state(spec, "cpu")
    want = lattice.init_state(spec, "cpu")
    before = lattice.scatter_step.launches
    lattice.scatter_step(spec, got, 20_000, key, ts, valid, cols,
                         mode=GLOBAL if forced else None)
    assert calls == [spec]
    assert lattice.scatter_step.launches == before
    ref(spec, want, 20_000, key, ts, valid, cols)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---- the touched extract's plan (csrc/touched.cu) ---------------------------

def look_back_model(counts, tile: int, threads: int, published) -> int:
    """lookback.cuh's look_back for tile `tile`: thread t reads the
    status words p = t, t + threads, ... below `tile`, 32 rounds at a
    time; a round whose count was not yet published (published[p] false
    at the first read) sets its bit in the chunk's mask, and the second
    pass waits on each set bit's word (then published) and adds it."""
    total = 0
    for t in range(threads):
        for c in range(t, tile, 32 * threads):
            rounds = list(range(c, min(tile, c + 32 * threads), threads))
            assert len(rounds) <= 32             # a bit each
            pending = 0
            for r, p in enumerate(rounds):
                if published[p]:
                    total += counts[p]
                else:
                    pending |= 1 << r
            for r, p in enumerate(rounds):
                if pending >> r & 1:
                    total += counts[p]
                    pending &= ~(1 << r)
            assert pending == 0
    return total


def compaction_model(flags: np.ndarray, max_out: int, tile: int = 4096,
                     per: int = 16, threads: int = 256):
    """touched_scan_kernel: tiles of `tile` flags, `per` a thread; a
    tile's offset from the look-back (the sum of the counts the tiles
    before it published, some of them not yet published at the first
    read), each set flag's cell at its global place when below max_out,
    n the last tile's inclusive prefix."""
    n_cells = len(flags)
    tiles = max(1, -(-n_cells // tile))
    counts = [int(flags[t * tile:(t + 1) * tile].astype(bool).sum())
              for t in range(tiles)]
    incl: dict[int, int] = {}
    cells = np.full(max_out, -1, np.int64)
    rng = np.random.default_rng(tiles)
    for t in range(tiles):       # tickets: a tile only waits on lower ones
        excl = look_back_model(counts, t, threads, rng.random(tiles) < 0.5)
        incl[t] = excl + counts[t]
        base = t * tile
        for th in range(0, tile, per):
            lo = base + th
            m = flags[lo:min(lo + per, n_cells)].astype(bool)
            before = int(flags[base:lo].astype(bool).sum())
            for k in np.nonzero(m)[0]:
                pos = excl + before
                if pos < max_out:
                    cells[pos] = lo + k
                before += 1
    return cells, incl[tiles - 1]


@pytest.mark.parametrize("n_cells,density,max_out", [
    (4096, 0.3, 4096), (4097, 0.3, 4097), (4097, 0.3, 100),
    (4096, 1.0, 4096), (3072, 0.0, 3072), (70_000, 0.25, 70_000),
    (70_000, 0.25, 5000), (150_000, 0.02, 1000), (33 * 4096 + 5, 0.1, 9999)])
def test_one_pass_compaction_model_is_nonzero_with_truncation(
        n_cells, density, max_out):
    """The compaction gives jnp.nonzero's order (extract_touched_ref's
    cells), drops places at or past max_out and still counts them in n:
    lattices of exactly 4096 and 4097 cells, n > max_out, n = 0, every
    flag set, and more than 32 tiles."""
    rng = np.random.default_rng(n_cells)
    flags = (rng.random(n_cells) < density).astype(np.uint8)
    cells, n = compaction_model(flags, max_out)
    hit = np.nonzero(flags)[0]
    assert n == len(hit)
    k = min(n, max_out)
    assert np.array_equal(cells[:k], hit[:k])
    assert (cells[k:] == -1).all()


@pytest.mark.parametrize("threads", [128, 256])
def test_look_back_sums_every_predecessor_past_32_rounds(threads):
    """A tile's offset is the sum of every count before it, whichever of
    them were published at the first read, also where a thread reads
    more than 32 rounds of status words: tiles past 32 * threads (the
    probe's 128 threads, 256 records a tile: a batch over 2^20 records;
    the touched scan's 256 threads, 4096 cells a tile: a lattice over
    2^25 cells)."""
    rng = np.random.default_rng(threads)
    n = 70 * threads + 3
    counts = rng.integers(0, 1 << 20, n).tolist()
    for tile in (0, 1, 32 * threads - 1, 32 * threads, 32 * threads + 1,
                 33 * threads + 7, 64 * threads, n - 1):
        for density in (0.0, 0.5, 0.97, 1.0):
            published = rng.random(n) < density
            assert look_back_model(counts, tile, threads, published) == \
                sum(counts[:tile])


def _touched_spec(n_keys: int, aggs=("COUNT_ALL",), window=None):
    ags = tuple(AggSpec(AggKind[a], f"o{i}",
                        input=None if a == "COUNT_ALL" else Col("x"),
                        k=2 if a.startswith("TOPK") else None)
                for i, a in enumerate(aggs))
    return lattice.LatticeSpec(n_keys=n_keys, aggs=ags, window=window,
                               track_touched=True)


def test_touched_plan_takes_one_launch_up_to_4096_cells():
    one, staged = kb.TOUCHED_ONE, kb.TOUCHED_STAGED
    chg = chip_smoke.scatter_specs()["changelog"]
    assert chg.n_keys * chg.n_slots == 3072
    assert lattice.touched_plan(chg, 3072) == one
    join = chip_smoke.scatter_specs()["join inner"]
    assert lattice.touched_plan(join, 1 << 20) == staged
    s_fit, s_over = _touched_spec(4096), _touched_spec(4097)  # W = 1
    assert lattice.touched_plan(s_fit, 100) == one
    assert lattice.touched_plan(s_over, 100) == staged
    assert lattice.touched_plan(s_fit, 100, mode=staged) == staged
    with pytest.raises(ValueError, match="4096 cells"):
        lattice.touched_plan(s_over, 100, mode=one)
    wide = _touched_spec(8, ("TOPK",) * 5)     # k = 2: 3 + 10 rows fit
    assert lattice.touched_plan(wide, 100) == one


@pytest.mark.parametrize("mode", [None, kb.TOUCHED_ONE, kb.TOUCHED_STAGED])
def test_extract_touched_on_cpu_tensors_runs_the_plain_version(mode):
    spec = _touched_spec(8, ("COUNT_ALL", "SUM", "TOPK"),
                         TumblingWindow(10_000, 0))
    st = lattice.init_state(spec, "cpu")
    st["touched"][1, 2] = True
    st["touched"][5, 0] = True
    ref = {k: v.clone() for k, v in st.items()}
    got = lattice.extract_touched(spec, st, 4, mode=mode)
    want = lattice.extract_touched_ref(spec, ref, 4)
    assert torch.equal(got, want) and int(got[0, 0]) == 2
    assert not bool(st["touched"].any())
