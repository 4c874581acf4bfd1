"""Parity of the port's wire transport with hstream_tpu's.

The port keeps a copy of the host encoder (BitpackTransport); it must give
byte-identical (combo, bases, words) for the same input, batch after batch
as its sticky width and demotion state evolves. The same words then
decode identically through the JAX decode_batch and the port's plain
decode_batch_ref (the CUDA kernel is held against decode_batch_ref by
chip_smoke.py on the card). Inputs are made from numpy seeds; every
comparison is exact.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from hstream_tpu.engine import transport as jtp
from hstream_tpu_torch.engine import transport as ttp


def _plans(combo):
    return [(p.name, p.enc, p.scale, p.bits) for p in combo]


def _decimals(rng, n, scale=10, loc=20.0, sd=5.0):
    return (np.rint(rng.normal(loc, sd, n) * scale).astype(np.float32)
            * np.float32(1.0 / scale))


def _stream(seed: int):
    """A sequence of batches that walks the codec through its cases:
    bp keys that widen, sorted ms timestamps (bpd) until an unsorted batch
    demotes them, one-decimal floats (dec) until a non-decimal batch
    demotes them to raw f32, ints that widen past the raw32 threshold,
    bools, a __valid stream and null streams."""
    rng = np.random.default_rng(seed)
    layout = (("temp", "f32"), ("x", "i32"), ("flag", "bool"))
    for i, n in enumerate((300, 512, 77, 1024, 999, 256, 640)):
        cap = 1 << max(8, int(np.ceil(np.log2(n))))
        kids = rng.integers(0, 8 << i, n).astype(np.int32)
        ts = np.sort(rng.integers(0, 50 * (i + 1), n)).astype(np.int64)
        if i == 4:
            ts = ts[::-1].copy()            # unsorted: bpd -> bp forever
        temp = _decimals(rng, n)
        if i == 5:
            temp = rng.normal(0, 1, n).astype(np.float32)  # dec -> raw
        x = rng.integers(-(1 << (3 * i)), 1 << (3 * i), n).astype(np.int32)
        if i == 6:
            x[0] = -(1 << 31) + 1           # past +-2^30: raw i32
        cols = {"temp": temp, "x": x,
                "flag": rng.integers(0, 2, n).astype(np.bool_)}
        valid = rng.integers(0, 5, n) > 0 if i % 2 else None
        nulls = ({"__null_a0": rng.integers(0, 7, n) == 0} if i % 3 == 0
                 else None)
        yield cap, n, kids, ts, cols, layout, valid, nulls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoder_is_byte_identical_batch_after_batch(seed):
    jt, tt = jtp.BitpackTransport(), ttp.BitpackTransport()
    encs = set()
    for cap, n, kids, ts, cols, layout, valid, nulls in _stream(seed):
        jc, jb, jw = jt.encode(cap, n, kids, ts, cols, layout, valid=valid,
                               null_streams=nulls)
        tc, tb, tw = tt.encode(cap, n, kids, ts, cols, layout, valid=valid,
                               null_streams=nulls)
        assert _plans(jc) == _plans(tc)
        np.testing.assert_array_equal(jb, tb)
        assert jw.dtype == tw.dtype == np.uint32
        np.testing.assert_array_equal(jw, tw)
        assert ttp.wire_bytes(tc, cap) == jtp.wire_bytes(jc, cap) == \
            jw.nbytes
        encs |= {p.enc for p in tc}
    assert encs == {"bp", "bpd", "bool1", "dec", "rawf", "rawi"}


def test_numpy_packer_matches_the_native_one(monkeypatch):
    """The port's numpy fallback (no g++) gives the reference's bytes."""
    for cap, n, kids, ts, cols, layout, valid, nulls in _stream(5):
        args = (cap, n, kids, ts, cols, layout)
        jc, jb, jw = jtp.BitpackTransport().encode(*args, valid=valid)
        with monkeypatch.context() as m:
            m.setattr(ttp, "_lib", lambda: None)
            tc, tb, tw = ttp.BitpackTransport().encode(*args, valid=valid)
        assert _plans(jc) == _plans(tc)
        np.testing.assert_array_equal(jb, tb)
        np.testing.assert_array_equal(jw, tw)


def _jax_decode(words, combo, cap, n, bases):
    out = jax.jit(lambda w, b: jtp.decode_batch(w, combo, cap, np.int32(n),
                                                b))(words, bases)
    k, ts, valid, cols = out
    return (np.asarray(k), np.asarray(ts), np.asarray(valid),
            {c: np.asarray(v) for c, v in cols.items()})


def _assert_decodes_match(jcombo, tcombo, bases, words, cap, n):
    jk, jts, jv, jcols = _jax_decode(words, jcombo, cap, n, bases)
    tk, tts, tv, tcols = ttp.decode_batch(
        torch.from_numpy(words.view(np.int32)), tcombo, cap, n, bases)
    np.testing.assert_array_equal(jk, tk.numpy())
    np.testing.assert_array_equal(jts, tts.numpy())
    np.testing.assert_array_equal(jv, tv.numpy())
    assert jcols.keys() == tcols.keys()
    for c in jcols:
        j, t = jcols[c], tcols[c].numpy()
        assert j.dtype == t.dtype, c
        # bitwise, so -0.0 and NaN payloads count too
        np.testing.assert_array_equal(j.view(np.uint8), t.view(np.uint8))


@pytest.mark.parametrize("seed", [0, 3])
def test_same_words_decode_identically(seed):
    tt = ttp.BitpackTransport()
    for cap, n, kids, ts, cols, layout, valid, nulls in _stream(seed):
        tc, tb, tw = tt.encode(cap, n, kids, ts, cols, layout, valid=valid,
                               null_streams=nulls)
        jc = tuple(jtp.StreamPlan(p.name, p.enc, p.scale, p.bits)
                   for p in tc)
        _assert_decodes_match(jc, tc, tb, tw, cap, n)


@pytest.mark.parametrize("bits", [0, 1, 3, 10, 16, 24, 32])
def test_every_ladder_width_decodes_identically(bits):
    rng = np.random.default_rng(bits)
    for n, cap in ((1, 256), (33, 256), (257, 512), (4096, 4096)):
        if bits == 32:
            x = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)
            x[0] = -(1 << 30)
            x[-1] = 1 << 30
        else:
            x = rng.integers(0, 1 << bits, n).astype(np.int64) - 5
        wide = np.sort(rng.integers(0, 1 << 31, n)).astype(np.int64) \
            if bits == 32 else np.zeros(n, np.int64)
        tc, tb, tw = ttp.BitpackTransport().encode(
            cap, n, np.zeros(n, np.int32), wide, {"x": x.astype(np.int32)},
            (("x", "i32"),))
        assert ("x", "bp", 0, bits) in _plans(tc) or n == 1
        jc = tuple(jtp.StreamPlan(p.name, p.enc, p.scale, p.bits)
                   for p in tc)
        _assert_decodes_match(jc, tc, tb, tw, cap, n)
