"""Parity of the port's plain sketch functions with hstream_tpu's.

Hash, register index and rank are integer functions and must match
exactly, for float32 (with -0.0 canonicalized and subnormals hashed as
0.0, as the reference's jitted step does), int32 and bool inputs.
The HLL estimate sums the registers' 2^-r terms exactly in the port and
in float32 in the reference: held to rel 1e-6, in both the
linear-counting and the harmonic-mean regime.

APPROX_QUANTILE: the bin is float32 arithmetic in both and must match
exactly, over values <= 0, in (0, min_value), on and past the range's
ends and non-finite; the estimate is the bin's geometric midpoint, whose
exp may differ in its last bit between XLA's and PyTorch's CPU code:
held to rel 1e-6, for q = 0, 0.5, 0.99 and 1 and an empty histogram.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from hstream_tpu.engine import sketches as js
from hstream_tpu_torch.engine import sketches as ts


def _values(kind: str, rng) -> np.ndarray:
    n = 4096
    if kind == "f32":
        v = rng.normal(0, 1e3, n).astype(np.float32)
        v[:4] = (0.0, -0.0, np.float32(1e-45), -np.float32(3.4e38))
        return v
    if kind == "i32":
        return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    return rng.integers(0, 2, n).astype(np.bool_)


@pytest.mark.parametrize("kind", ["f32", "i32", "bool"])
@pytest.mark.parametrize("p", [4, 10, 14])
def test_hash_register_and_rank_match(kind, p):
    v = _values(kind, np.random.default_rng(p))
    # jitted, as the reference's step runs them: its -0.0 test is then an
    # XLA comparison, which flushes the subnormal 1e-45 to 0.0 (called
    # eagerly on a numpy array it is numpy's, which does not)
    jh = np.asarray(jax.jit(js.hash_u32)(v))
    th = ts.hash_u32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(th, jh.astype(np.int64))
    jr, jk = jax.jit(js.hll_update_indices, static_argnums=1)(
        v, js.HLLConfig(p))
    tr, tk = ts.hll_update_indices(torch.from_numpy(v), ts.HLLConfig(p))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk.max() <= ts.HLLConfig(p).max_rank


def test_clz_matches_on_edges():
    x = np.array([0, 1, 2, 3, 0x80000000, 0xFFFFFFFF, 0x00010000],
                 np.uint32)
    np.testing.assert_array_equal(
        ts.clz32(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(js.clz32(x)))


@pytest.mark.parametrize("distinct", [0, 5, 300, 5000, 200_000])
def test_estimate_matches_in_both_regimes(distinct):
    rng = np.random.default_rng(distinct)
    cfg_j, cfg_t = js.HLLConfig(), ts.HLLConfig()
    regs = np.zeros((3, cfg_j.m), np.int8)
    for row in range(3):
        v = rng.normal(0, 1e6, distinct).astype(np.float32)
        reg, rank = js.hll_update_indices(v, cfg_j)
        np.maximum.at(regs[row], np.asarray(reg), np.asarray(rank))
    want = np.asarray(js.hll_estimate(regs, cfg_j))
    got = ts.hll_estimate(torch.from_numpy(regs), cfg_t).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _quantile_values(rng) -> np.ndarray:
    v = np.concatenate([
        rng.lognormal(0, 6, 20_000), -rng.random(100),
        rng.random(100) * 1e-6, rng.lognormal(25, 3, 200),
        np.rint(rng.normal(20, 5, 2000) * 10) / 10]).astype(np.float32)
    edges = np.float32(1e-6) * np.exp(
        np.arange(0, 512) * ts.QuantileConfig().gamma_log)
    return np.concatenate([v, edges.astype(np.float32), np.array(
        [0.0, -0.0, 1e-6, 1e9, 3.4e38, np.nan, np.inf, -np.inf],
        np.float32)])


def test_quantile_bins_match():
    v = _quantile_values(np.random.default_rng(3))
    want = np.asarray(js.quantile_bin(v, js.QuantileConfig()))
    got = ts.quantile_bin(torch.from_numpy(v), ts.QuantileConfig()).numpy()
    finite = np.isfinite(v)           # non-finite inputs never count
    np.testing.assert_array_equal(got[finite], want[finite])
    assert got.dtype == np.int32
    assert {0, 1, 511} <= set(got[finite].tolist())


@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0])
def test_quantile_estimate_matches(q):
    rng = np.random.default_rng(int(q * 100))
    cfg_j, cfg_t = js.QuantileConfig(), ts.QuantileConfig()
    hist = np.zeros((6, cfg_j.n_bins), np.int32)
    for row in range(1, 6):          # row 0: an empty histogram
        b = np.asarray(js.quantile_bin(
            rng.lognormal(row, 2, 1000 * row).astype(np.float32), cfg_j))
        np.add.at(hist[row], b, 1)
    want = np.asarray(js.quantile_estimate(hist, q, cfg_j))
    got = ts.quantile_estimate(torch.from_numpy(hist), q, cfg_t).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
