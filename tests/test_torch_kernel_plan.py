"""The host-side plan that picks the scatter kernel's branch
(lattice.scatter_plan): block-private when the [K, W] planes fit in a
block's shared memory, else global atomics; and the wrapper's CPU path,
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
