"""Streaming sketches as plain PyTorch ops (the port of
hstream_tpu/engine/sketches.py:35-107).

HyperLogLog (APPROX_COUNT_DISTINCT): int8 registers [..., m], m = 2^p.
An update is a scatter-max of the leading-zero rank of a 32-bit hash; the
estimate is the bias-corrected harmonic mean with the linear-counting
small-range correction.

These are the plain versions of what the scatter and close kernels
compute on the card (engine/kernels/csrc/scatter.cu, close.cu); the two
must agree bit for bit, so the arithmetic is spelled out here exactly as
the kernels do it:

* the hash runs in int64 with every product masked to 32 bits — torch's
  uint32 arithmetic is incomplete on the CPU, and int64 products of two
  32-bit values would overflow, so each multiply is split in 16-bit
  halves;
* the estimate sums the registers' 2^-r terms EXACTLY, as the integer
  sum of 2^(R-r) with R = 33-p the largest rank, rounded once to
  float32. The sum is then independent of the order it is taken in, so
  the kernel's parallel reduction and this version agree exactly; the
  rest is the reference's float32 arithmetic, operation for operation
  (the reference sums float32 in XLA's order; the parity tests hold the
  two within rel 1e-6).

APPROX_QUANTILE (sketches.py:114-155): a log-binned int32 histogram
[..., n_bins]. The bin is the reference's float32 arithmetic, one
operation at a time, which the scatter kernel repeats (logf there and
torch.log here are the same libdevice function on the card). The
estimate scans the CDF as exact integers and compares it as float32 (the
reference's float32 cumsum is exact while a cell holds fewer than 2^24
values), then takes the bin's geometric midpoint in float32, as the close
and changelog kernels do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from hstream_tpu_torch.engine.expr import ftz

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_u32(values: torch.Tensor) -> torch.Tensor:
    """Hash a float32/int32/bool column to uint32 (held in int64)."""
    if values.dtype == torch.float32:
        # canonicalize -0.0 == 0.0 before the bitcast (sketches.py:50)
        # (a comparison: XLA flushes a subnormal, so it hashes as 0.0)
        values = torch.where(ftz(values) == 0.0, torch.zeros_like(values),
                             values)
        bits = values.view(torch.int32).to(torch.int64) & _M32
    else:
        bits = values.to(torch.int32).to(torch.int64) & _M32
    return _mix32(bits)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of uint32 values held in int64 (32 for 0)."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        hi_empty = (x >> (32 - shift)) == 0
        n = n + torch.where(hi_empty, shift, 0)
        x = torch.where(hi_empty, (x << shift) & _M32, x)
    return torch.where(x == 0, 32, n)


@dataclass(frozen=True)
class HLLConfig:
    precision: int = 10  # m = 1024 registers, ~3.2% standard error

    @property
    def m(self) -> int:
        return 1 << self.precision

    @property
    def max_rank(self) -> int:
        """Largest rank a register can hold: 32 - p + 1."""
        return 33 - self.precision


def hll_update_indices(values: torch.Tensor, cfg: HLLConfig):
    """Per-record (register index int64, rank int64) for the scatter-max."""
    h = hash_u32(values)
    p = cfg.precision
    reg = h >> (32 - p)
    w = (h << p) & _M32  # remaining 32-p bits, left-aligned
    rank = torch.clamp(clz32(w) + 1, max=cfg.max_rank)
    return reg, rank


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def hll_estimate(registers: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """Estimate cardinality from int8 registers [..., m] -> float32 [...]."""
    m, big_r = cfg.m, cfg.max_rank
    r = registers.to(torch.int64)
    terms = torch.ones_like(r) << (big_r - r)
    denom = terms.sum(-1).to(torch.float32) * 2.0 ** -big_r
    f32 = dict(dtype=torch.float32, device=registers.device)
    raw = torch.tensor(_alpha(m) * m * m, **f32) / denom
    zeros = (r == 0).sum(-1).to(torch.float32)
    linear = m * torch.log(torch.tensor(m, **f32)
                           / torch.clamp(zeros, min=1.0))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_linear, linear, raw)


@dataclass(frozen=True)
class QuantileConfig:
    """Geometric buckets over [min_value, max_value]; values below
    min_value (incl. zero/negatives) land in bucket 0."""

    n_bins: int = 512
    min_value: float = 1e-6
    max_value: float = 1e9

    @property
    def gamma_log(self) -> float:
        return math.log(self.max_value / self.min_value) / (self.n_bins - 1)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def quantile_bin(values: torch.Tensor, cfg: QuantileConfig) -> torch.Tensor:
    """Bucket index int32 [...] for the values (as float32)."""
    v = values.to(torch.float32)
    lo = _f32(cfg.min_value, v.device)
    v = torch.maximum(v, _f32(0.0, v.device))
    safe = torch.maximum(v, lo)
    b = torch.floor(torch.log(safe / lo) / _f32(cfg.gamma_log, v.device))
    b = torch.clamp(b.to(torch.int32) + 1, 1, cfg.n_bins - 1)
    return torch.where(v < lo, torch.zeros_like(b), b)


def quantile_estimate(hist: torch.Tensor, q: float,
                      cfg: QuantileConfig) -> torch.Tensor:
    """q-quantile from histogram counts [..., n_bins] -> float32 [...]:
    the geometric midpoint of the first bucket whose CDF reaches
    q * max(total, 1) (bucket 0 -> 0.0)."""
    dev = hist.device
    counts = hist.to(torch.int64)
    total = counts.sum(-1, keepdim=True).to(torch.float32)
    cdf = torch.cumsum(counts, -1).to(torch.float32)
    target = _f32(q, dev) * torch.clamp(total, min=1.0)
    idx = (cdf < target).sum(-1)
    idx = torch.clamp(idx, 0, cfg.n_bins - 1)
    log_lo = (idx.to(torch.float32) - 1.0) * _f32(cfg.gamma_log, dev)
    mid = _f32(cfg.min_value, dev) * torch.exp(
        log_lo + _f32(0.5 * cfg.gamma_log, dev))
    return torch.where(idx == 0, torch.zeros_like(mid), mid)
