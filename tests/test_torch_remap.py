"""The code remap (B14, csrc/session_remap.cu) and the rebase (B4,
csrc/rebase.cu) as redesigned for the H100, on the CPU.

The kernels run only on the card; here their plain versions are held
against the JAX package's programs at the tail shapes the new designs
split on (a plane whose length is not a multiple of four, codes at and
above the table, the sentinel flag both ways), and numpy models of the
kernels' index maps check that every element is visited exactly once
whatever the plane's alignment:

- the remap's C entry: `head` scalar codes up to the first 16-byte
  boundary (0-3), `n4` whole quads by a grid-stride loop over
  min(SMs x 8, ceil(n4 / 256)) blocks of 256 threads, then the last 0-3
  codes, taken by the first threads;
- the rebase: one warp a block, two slots a lane, blocks of 64 slots.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hstream_tpu.engine import lattice as JL
from hstream_tpu_torch.engine import lattice as tl
from hstream_tpu_torch.engine import session_lattice as sl

SENT = JL.JOIN_SENT_CODE
CAPS = [1, 2, 3, 5, 6, 7, 13, 1026, 4099]


def _codes(rng, cap: int, lcap: int) -> np.ndarray:
    code = rng.integers(0, 2 * lcap, cap).astype(np.int32)
    code[::5] = lcap          # exactly at the table's end
    code[1::7] = lcap - 1     # its last entry
    code[2::9] = SENT
    return code


@pytest.mark.parametrize("cap", CAPS)
def test_plain_remap_matches_the_reference_at_tail_shapes(cap):
    """Without the flag: the reference's session_remap_kernel (codes at
    or above the table pass through)."""
    rng = np.random.default_rng(cap)
    lcap = 16
    code = _codes(rng, cap, lcap)
    lut = rng.permutation(lcap).astype(np.int32)
    lut[::3] = SENT
    want = np.asarray(JL.session_remap_kernel(cap, lcap)(
        {"code": jnp.asarray(code)}, jnp.asarray(lut))["code"])
    t = {"code": torch.from_numpy(code.copy())}
    sl.session_remap(t, torch.from_numpy(lut))
    assert np.array_equal(t["code"].numpy(), want)


@pytest.mark.parametrize("cap", CAPS)
def test_flagged_remap_matches_the_joins_remap_at_tail_shapes(cap):
    """With sent_above: the reference join's _remap_device_codes
    (join.py:2092-2108; codes at or above the table become the
    sentinel), as jnp computes it."""
    rng = np.random.default_rng(100 + cap)
    lcap = 16
    code = _codes(rng, cap, lcap)
    table = np.sort(rng.choice(64, lcap, replace=False)).astype(np.int32)
    jcode = jnp.asarray(code)
    live = jcode < np.int32(lcap)
    want = np.asarray(jnp.where(live, jnp.asarray(table)[
        jnp.where(live, jcode, 0)], JL.JOIN_SENT_CODE))
    t = {"code": torch.from_numpy(code.copy())}
    sl.session_remap(t, torch.from_numpy(table), sent_above=True)
    assert np.array_equal(t["code"].numpy(), want)


def remap_model(code: np.ndarray, lut: np.ndarray, sent_above: bool,
                mis_bytes: int, sms: int = 132) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """csrc/session_remap.cu's index map over a plane whose base lies
    `mis_bytes` past a 16-byte boundary: (result, visits per code)."""
    cap, lcap = len(code), len(lut)
    head = 0 if mis_bytes == 0 else (16 - mis_bytes) >> 2
    head = min(head, cap)
    n4 = (cap - head) >> 2
    threads = 256
    blocks = max(min(sms * 8, (n4 + threads - 1) // threads), 1)
    stride = blocks * threads
    out = code.copy()
    visits = np.zeros(cap, np.int64)

    def one(c):
        if c < lcap:
            return lut[max(c, 0)]
        return SENT if sent_above else c

    for tid in range(stride):
        for q in range(tid, n4, stride):
            for j in range(4):
                i = head + 4 * q + j
                out[i] = one(code[i])
                visits[i] += 1
        tail0 = head + 4 * n4
        if tid < head:
            out[tid] = one(code[tid])
            visits[tid] += 1
        if tid < cap - tail0:
            out[tail0 + tid] = one(code[tail0 + tid])
            visits[tail0 + tid] += 1
    return out, visits


@pytest.mark.parametrize("sent_above", [False, True])
@pytest.mark.parametrize("mis_bytes", [0, 4, 8, 12])
@pytest.mark.parametrize("cap", [1, 3, 4, 5, 11, 1030])
def test_remap_kernel_index_map_visits_each_code_once(cap, mis_bytes,
                                                      sent_above):
    rng = np.random.default_rng(cap * 17 + mis_bytes)
    lcap = 8
    code = _codes(rng, cap, lcap)
    lut = rng.permutation(lcap).astype(np.int32)
    got, visits = remap_model(code, lut, sent_above, mis_bytes, sms=2)
    assert (visits == 1).all()
    t = {"code": torch.from_numpy(code.copy())}
    sl.session_remap(t, torch.from_numpy(lut), sent_above=sent_above)
    assert np.array_equal(got, t["code"].numpy())


def test_remap_grid_stride_covers_a_store_larger_than_the_grid():
    """The join store's shape class: more quads than the card's resident
    threads (a small SM count stands in for 132), so threads loop."""
    rng = np.random.default_rng(9)
    cap, lcap = 2 * 8 * 256 * 4 * 3 + 7, 32
    code = _codes(rng, cap, lcap)
    lut = rng.permutation(lcap).astype(np.int32)
    got, visits = remap_model(code, lut, True, 8, sms=2)
    assert (visits == 1).all()
    t = {"code": torch.from_numpy(code.copy())}
    sl.session_remap(t, torch.from_numpy(lut), sent_above=True)
    assert np.array_equal(got, t["code"].numpy())


def rebase_model(n_slots: int) -> np.ndarray:
    """csrc/rebase.cu's index map: visits per slot."""
    lanes, per = 32, 2
    blocks = (n_slots + lanes * per - 1) // (lanes * per)
    visits = np.zeros(n_slots, np.int64)
    for b in range(blocks):
        for lane in range(lanes):
            for j in range(per):
                w = b * lanes * per + lane + j * lanes
                if w < n_slots:
                    visits[w] += 1
    return visits


@pytest.mark.parametrize("n_slots",
                         [1, 3, 8, 31, 32, 33, 63, 64, 65, 200, 8641])
def test_rebase_visits_each_slot_once_and_matches_the_reference(n_slots):
    assert (rebase_model(n_slots) == 1).all()
    rng = np.random.default_rng(n_slots)
    ss = rng.integers(-(1 << 30), 1 << 30, n_slots).astype(np.int32)
    ss[::3] = JL.EMPTY_START
    delta = int(rng.integers(1, 1 << 20))
    want = np.asarray(JL.rebase({"slot_start": jnp.asarray(ss)},
                                np.int32(delta))["slot_start"])
    st = {"slot_start": torch.from_numpy(ss.copy())}
    tl.rebase(st, delta)
    assert np.array_equal(st["slot_start"].numpy(), want)
