"""Seeded jittered exponential backoff, shared by every retry loop
that must not spin hot (follower reconnect, query supervision).

One formula so a fix to the jitter/cap/floor semantics reaches every
caller: ``base * 2^attempt`` capped, +/- uniform jitter from the
caller's seeded RNG (chaos runs replay the same wait sequence)."""

# A copy of hstream_tpu/common/backoff.py; the port imports nothing of the JAX
# package.
from __future__ import annotations

import random

__all__ = ["jittered_backoff"]


def jittered_backoff(attempt: int, *, base: float, cap: float,
                     jitter: float, rng: random.Random,
                     floor: float = 0.0, max_exp: int = 16) -> float:
    """Wait before retry ``attempt`` (zero-based: the first retry is
    attempt 0). ``max_exp`` bounds the exponent so a long outage can't
    overflow the float before ``cap`` clamps it."""
    b = min(base * (2.0 ** min(max(attempt, 0), max_exp)), cap)
    span = b * jitter
    return max(floor, b + rng.uniform(-span, span))
