"""Parity of the port's lattice (plain PyTorch versions) with hstream_tpu's.

The same wire words, made from numpy seeds, go through the JAX package's
jitted step (compiled_encoded_step) and the port's step_encoded, which on
CPU tensors runs the plain decode and scatter; then through the fused
close in its three modes, rebase and grow_keys. Both configurations of
the slice are covered — BASELINE 1/3 (TUMBLE(10s) COUNT/SUM/HLL) and
BASELINE 2 (HOP(60s,10s) AVG/MIN/MAX) — plus a windowless group-by.

Tolerances: integer planes, slot_start, HLL registers, MIN/MAX and the
packed integer rows exact; float32 SUM/AVG sums and the HLL estimate
rel 1e-6 (the reference's own bound, tests/test_close_batched.py): the
port sums HLL terms exactly in integers where the reference sums float32
in XLA's order. The CUDA kernels are held against these plain versions by
chip_smoke.py on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hstream_tpu.engine import lattice as jl
from hstream_tpu.engine import transport as jtp
from hstream_tpu.engine.expr import Col as JCol
from hstream_tpu.engine.plan import AggKind as JKind
from hstream_tpu.engine.plan import AggSpec as JAgg
from hstream_tpu.engine.types import ColumnType as JType
from hstream_tpu.engine.types import Schema as JSchema
from hstream_tpu.engine.window import HoppingWindow as JHop
from hstream_tpu.engine.window import TumblingWindow as JTumble
from hstream_tpu_torch.engine import convert
from hstream_tpu_torch.engine import lattice as tl
from hstream_tpu_torch.engine import transport as ttp
from hstream_tpu_torch.engine.expr import Col
from hstream_tpu_torch.engine.plan import AggKind, AggSpec
from hstream_tpu_torch.engine.window import HoppingWindow, TumblingWindow

K = 16
SCHEMA = JSchema.of(device=JType.STRING, temp=JType.FLOAT)
CONFIGS = {
    "tumble": ((JTumble(10_000, grace_ms=0), TumblingWindow(10_000, 0)),
               [("COUNT_ALL", None), ("SUM", "temp"),
                ("APPROX_COUNT_DISTINCT", "temp")]),
    "hop": ((JHop(60_000, 10_000, grace_ms=0),
             HoppingWindow(60_000, 10_000, grace_ms=0)),
            [("AVG", "temp"), ("MIN", "temp"), ("MAX", "temp")]),
    "global": ((None, None),
               [("SUM", "temp"), ("MIN", "temp"),
                ("APPROX_COUNT_DISTINCT", "temp")]),
}
EXACT_KINDS = ("COUNT_ALL", "MIN", "MAX")


def specs(cfg: str, n_keys: int = K):
    (jw, tw), aggs = CONFIGS[cfg]
    ja = tuple(JAgg(JKind[k], f"o{i}", input=JCol(c) if c else None)
               for i, (k, c) in enumerate(aggs))
    ta = tuple(AggSpec(AggKind[k], f"o{i}", input=Col(c) if c else None)
               for i, (k, c) in enumerate(aggs))
    return (jl.LatticeSpec(n_keys=n_keys, window=jw, aggs=ja),
            tl.LatticeSpec(n_keys=n_keys, window=tw, aggs=ta))


def batches(seed: int):
    """(cap, n, key ids, relative ts, temps, watermark) per batch: keys
    past K, records before the epoch (negative ts), late records, NaN,
    inf and -0.0 inputs, one-decimal floats (dec) and raw floats."""
    rng = np.random.default_rng(seed)
    wm = -1
    t0 = 80_000
    for i, n in enumerate((200, 333, 64, 500)):
        cap = 256 if n <= 256 else 512
        kids = rng.integers(0, K + 3, n).astype(np.int32)
        ts = np.sort(t0 + rng.integers(-15_000, 25_000, n)).astype(np.int64)
        ts[:5] = -rng.integers(1, 20_000, 5)
        temps = (np.rint(rng.normal(20, 5, n) * 10).astype(np.float32)
                 * np.float32(0.1))
        if i % 2:
            temps[::17] = np.nan
            temps[3::29] = np.inf
            temps[5::31] = -0.0
        yield cap, n, kids, ts, temps, wm
        wm = int(ts.max())
        t0 += 20_000


def jax_state_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def assert_states(jspec, jstate, tstate):
    j = jax_state_np(jstate)
    t = convert.state_to_numpy(tstate)
    assert j.keys() == t.keys()
    sums = {jl._plane_name(i, a) for i, a in enumerate(jspec.aggs)
            if a.kind in (JKind.SUM, JKind.AVG)}
    for k in j:
        assert j[k].dtype == t[k].dtype, k
        if k in sums:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def assert_packed(jspec, jpacked, tpacked):
    j, t = np.asarray(jpacked), tpacked.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype == np.int32
    np.testing.assert_array_equal(t[:, :2], j[:, :2])   # count, win start
    for i, agg in enumerate(jspec.aggs):
        jr, tr = j[:, 2 + i].view(np.float32), t[:, 2 + i].view(np.float32)
        if agg.kind.name in EXACT_KINDS:
            np.testing.assert_array_equal(tr, jr, err_msg=agg.kind.name)
        else:
            np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=0,
                                       err_msg=agg.kind.name)


def run_steps(cfg: str, seed: int):
    """Both lattices through the same wire words; asserts after each."""
    jspec, tspec = specs(cfg)
    jstate = jl.init_state(jspec)
    tstate = convert.state_from_numpy(jax_state_np(jstate), "cpu")
    assert_states(jspec, jstate, tstate)
    enc = ttp.BitpackTransport()
    for cap, n, kids, ts, temps, wm in batches(seed):
        combo, bases, words = enc.encode(cap, n, kids, ts, {"temp": temps},
                                         (("temp", "f32"),))
        jcombo = tuple(jtp.StreamPlan(p.name, p.enc, p.scale, p.bits)
                       for p in combo)
        step = jl.compiled_encoded_step(jspec, SCHEMA, None, jcombo, cap)
        jstate = step(jstate, np.int32(wm), np.int32(n), bases, words)
        tl.step_encoded(tspec, tstate, wm, n, bases,
                        torch.from_numpy(words.view(np.int32)), combo, cap)
        assert_states(jspec, jstate, tstate)
    assert int(tstate["count"].sum()) > 0
    return jspec, tspec, jstate, tstate


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_step_matches_the_jax_step(cfg, seed):
    run_steps(cfg, seed)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_plain_close_matches_the_jax_close_in_every_mode(cfg):
    jspec, tspec, jstate, tstate = run_steps(cfg, 7)
    W = tspec.n_slots
    picks = [[0], list(range(W))] if W == 1 else \
        [[1, W - 1], [0, 2, W - 2], list(range(W))]
    for sel in picks:
        slots = tl.pad_slots(sel)
        # extract only (peek): nothing changes
        jp = jl.build_extract_slots(jspec)(jstate, slots)
        tp = tl.close_slots(tspec, tstate, slots, tl.CLOSE_EXTRACT)
        assert_packed(jspec, jp, tp)
        assert_states(jspec, jstate, tstate)
    # extract + reset, from pre-reset values, with padding in the vector
    slots = tl.pad_slots(picks[0])
    jstate, jp = jl.build_extract_reset_slots(jspec)(jstate, slots)
    tp = tl.close_slots(tspec, tstate, slots)
    assert_packed(jspec, jp, tp)
    assert_states(jspec, jstate, tstate)
    # host-side decode of one slot's rows, and the columnar gather
    jc, jw, jo = jl.unpack_extract_rows(jspec, np.asarray(jp)[0])
    tc, tw, to = tl.unpack_extract_rows(tspec, tp.numpy()[0])
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tw, jw)
    assert jo.keys() == to.keys()
    widx, kids = np.nonzero(tp.numpy()[:, 0, :] > 0)
    jg = jl.gather_extract_batch(jspec, np.asarray(jp), widx, kids)
    tg = tl.gather_extract_batch(tspec, tp.numpy(), widx, kids)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], rtol=1e-6, atol=0)
    # reset only
    slots = tl.pad_slots(picks[-1][:2])
    jstate = jl.build_reset_slots(jspec)(jstate, slots)
    assert tl.close_slots(tspec, tstate, slots, tl.CLOSE_RESET) is None
    assert_states(jspec, jstate, tstate)


def test_close_refuses_a_slot_named_twice():
    _, tspec = specs("tumble")
    state = tl.init_state(tspec, "cpu")
    with pytest.raises(ValueError, match="named twice"):
        tl.close_slots(tspec, state, np.array([1, 1], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        tl.close_slots(tspec, state, np.array([7], np.int32))


@pytest.mark.parametrize("cfg", ["tumble", "hop"])
def test_rebase_and_grow_keys_match(cfg):
    jspec, tspec, jstate, tstate = run_steps(cfg, 3)
    # free one slot first: an empty slot must keep its sentinel
    slots = tl.pad_slots([1])
    jstate = jl.build_reset_slots(jspec)(jstate, slots)
    tl.close_slots(tspec, tstate, slots, tl.CLOSE_RESET)
    delta = tspec.n_slots * tspec.window.advance_ms
    jstate = jl.rebase(jstate, np.int32(delta))
    tl.rebase(tstate, delta)
    assert_states(jspec, jstate, tstate)
    assert int(tstate["slot_start"][1]) == tl.EMPTY_START
    jg = jl.grow_keys(jstate, jspec, 2 * K)
    tg = tl.grow_keys(tstate, tspec, 2 * K)
    jspec2, _ = specs(cfg, 2 * K)
    assert_states(jspec2, jg, tg)


def test_state_round_trips_through_numpy():
    jspec, _, jstate, tstate = run_steps("tumble", 4)
    back = convert.state_from_numpy(convert.state_to_numpy(tstate), "cpu")
    for k in tstate:
        assert torch.equal(back[k], tstate[k])
    with pytest.raises(ValueError, match="dtype"):
        convert.state_from_numpy({"count": np.zeros(3, np.int64)}, "cpu")


def test_plane_merge_kinds_and_agg_widths_match():
    for cfg in CONFIGS:
        jspec, tspec = specs(cfg)
        assert tl.plane_merge_kinds(tspec) == jl.plane_merge_kinds(jspec)
        assert [tl.agg_width(a) for a in tspec.aggs] == \
            [jl.agg_width(a) for a in jspec.aggs]
