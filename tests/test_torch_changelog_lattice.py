"""Parity of the port's changelog-query lattice (plain PyTorch versions)
with hstream_tpu's: the step with a WHERE mask, computed inputs, SQL
NULL masks, COUNT(col), APPROX_QUANTILE, TOPK and TOPK_DISTINCT against
build_step_fn; the changelog extract against build_extract_touched; the
reset-only close against build_reset_slots; the fused close's quantile
and TOPK rows against build_extract_reset_slots.

Inputs come from numpy seeds: keys past K, records before the epoch and
late ones, invalid rows, NaN / +-inf / -0.0 / values <= 0 and below the
quantile range, ties, and NULLs on every column. Tolerances: integer
planes (counts, quantile bins, HLL registers), slot_start, touched,
MIN/MAX (by value: +0.0 against -0.0 depends on the order of the
updates, in both engines), the TOPK planes and the packed integer rows
exact; float32 SUM/AVG sums and the finalized SUM / AVG / HLL values rel
1e-6 (the reference sums in XLA's order). A finalized quantile is the
same bucket exactly and its midpoint within rel 4e-6: inside its jitted
extract, XLA contracts (idx - 1) * gamma + gamma / 2 into one FMA before
the exp, and an ulp of that argument (~1.9e-6 near 30) is a relative
error of the midpoint. The CUDA kernels are held against these plain
versions bit for bit by chip_smoke.py on the card.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import hstream_tpu.engine as J
from hstream_tpu.engine import expr as je
from hstream_tpu.engine import lattice as jl
import hstream_tpu_torch.engine as T
from hstream_tpu_torch.engine import convert
from hstream_tpu_torch.engine import expr as te
from hstream_tpu_torch.engine import lattice as tl

K = 12
WINDOWS = {"tumble": lambda m: m.TumblingWindow(10_000, grace_ms=0),
           "hop": lambda m: m.HoppingWindow(30_000, 10_000, grace_ms=0),
           "global": lambda m: None}
COLS = ("temp", "hum", "cnt", "flag")


def _schema(m):
    return m.Schema.of(device=m.ColumnType.STRING, temp=m.ColumnType.FLOAT,
                       hum=m.ColumnType.FLOAT, cnt=m.ColumnType.INT,
                       flag=m.ColumnType.BOOL)


def _aggs(m, e):
    A, S = m.AggKind, m.AggSpec
    temp, hum, cnt = e.Col("temp"), e.Col("hum"), e.Col("cnt")
    return (S(A.COUNT, "c", input=temp),
            S(A.SUM, "s", input=e.BinOp("+", e.BinOp("*", temp, e.Lit(1.8)),
                                        e.Lit(32))),
            S(A.AVG, "a", input=hum),
            S(A.MIN, "lo", input=temp), S(A.MAX, "hi", input=temp),
            S(A.APPROX_COUNT_DISTINCT, "u", input=cnt),
            S(A.APPROX_QUANTILE, "q", input=temp, quantile=0.9),
            S(A.APPROX_QUANTILE, "q2", input=e.BinOp("*", hum, e.Lit(2)),
              quantile=0.5),
            S(A.TOPK, "t", input=temp, k=3),
            S(A.TOPK_DISTINCT, "td", input=temp, k=3),
            S(A.TOPK, "ti", input=cnt, k=2),
            S(A.COUNT_ALL, "call"))


def _where(e):
    return e.BinOp("AND", e.BinOp(">", e.Col("temp"), e.Lit(-1.0)),
                   e.UnOp("NOT", e.Col("flag")))


def specs(win: str, n_keys: int = K):
    jspec = jl.LatticeSpec(n_keys=n_keys, window=WINDOWS[win](J),
                           aggs=_aggs(J, je))
    tspec = tl.LatticeSpec(n_keys=n_keys, window=WINDOWS[win](T),
                           aggs=_aggs(T, te))
    return jspec, tspec


SUBNORMALS = np.array([1e-45, -1e-45, 1e-40, -3e-39, 0.0, -0.0, 2.0],
                      np.float32)


def batches(seed: int, n_batches: int = 4, subnormals: bool = False):
    """(key ids, relative ts, valid, columns, per-column NULL masks,
    watermark) per batch; with `subnormals`, a quarter of temp and a fifth
    of hum drawn from SUBNORMALS."""
    rng = np.random.default_rng(seed)
    wm, t0 = -1, 60_000
    pool = np.array([-2.0, -0.0, 0.0, 1e-7, 1.0, 1.0, 2.5, 3.0, np.nan,
                     np.inf, -np.inf], np.float32)
    for _ in range(n_batches):
        n = int(rng.integers(150, 400))
        key = rng.integers(0, K + 2, n).astype(np.int32)
        key[key == K - 1] = 0          # key K-1: one record, fewer than k
        key[0] = K - 1
        ts = (t0 + rng.integers(-12_000, 18_000, n)).astype(np.int32)
        ts[:4] = -rng.integers(1, 9_000, 4)
        temp = (np.rint(rng.normal(5, 6, n) * 4) / 4).astype(np.float32)
        temp[::5] = pool[rng.integers(0, len(pool), temp[::5].shape[0])]
        cols = {"temp": temp,
                "hum": rng.lognormal(0, 3, n).astype(np.float32),
                "cnt": rng.integers(-50, 50, n).astype(np.int32),
                "flag": rng.random(n) < 0.2}
        if subnormals:
            for c, part in (("temp", slice(1, None, 4)),
                            ("hum", slice(2, None, 5))):
                x = cols[c][part]
                x[:] = SUBNORMALS[rng.integers(0, len(SUBNORMALS), len(x))]
        nulls = {c: rng.random(n) < 0.08 for c in COLS}
        valid = rng.random(n) < 0.95
        yield key, ts, valid, cols, nulls, wm
        wm = int(ts.max())
        t0 += 20_000


def step_inputs(spec, schema_cols, cols, nulls, valid, where_cols):
    """The step's columns with the aggregates' __null_a{i} masks (OR of
    the referenced columns' NULLs), and valid with the WHERE columns'
    NULLs cleared, as the executors encode them."""
    out = dict(cols)
    for i, agg in enumerate(spec.aggs):
        if agg.input is not None:
            m = np.zeros(len(valid), np.bool_)
            for c in sorted(je.columns_of(agg.input)
                            if isinstance(agg.input, je.Expr)
                            else te.columns_of(agg.input)):
                m |= nulls[c]
            out[f"__null_a{i}"] = m
    v = valid.copy()
    for c in where_cols:
        v &= ~nulls[c]
    return out, v


def run_steps(win: str, seed: int, subnormals: bool = False):
    jspec, tspec = specs(win)
    jschema, tschema = _schema(J), _schema(T)
    agg_inputs, _ = jl.compile_agg_inputs(jspec, jschema)
    jstep = jax.jit(jl.build_step_fn(
        jspec, agg_inputs, je.compile_device(_where(je), jschema)))
    progs = tl.step_programs(tspec, tschema, _where(te))
    jstate = jl.init_state(jspec)
    tstate = tl.init_state(tspec, "cpu")
    for key, ts, valid, cols, nulls, wm in batches(seed,
                                                   subnormals=subnormals):
        c, v = step_inputs(jspec, None, cols, nulls, valid,
                           ("temp", "flag"))
        jstate = jstep(jstate, np.int32(wm), key, ts, v, c)
        tc = {k: torch.from_numpy(np.ascontiguousarray(a))
              for k, a in c.items()}
        tl.step_decoded(tspec, tstate, wm, torch.from_numpy(key),
                        torch.from_numpy(ts), torch.from_numpy(v), tc, progs)
        yield jspec, tspec, jstate, tstate


def assert_states(jspec, jstate, tstate, skip=()):
    j = {k: np.asarray(v) for k, v in jstate.items() if k not in skip}
    t = {k: v for k, v in convert.state_to_numpy(tstate).items()
         if k not in skip}
    assert j.keys() == t.keys()
    sums = {jl._plane_name(i, a) for i, a in enumerate(jspec.aggs)
            if a.kind in (J.AggKind.SUM, J.AggKind.AVG)}
    # MIN/MAX of +0.0 and -0.0 is either, by the order of the updates,
    # in both engines: compared by value
    extrema = {jl._plane_name(i, a) for i, a in enumerate(jspec.aggs)
               if a.kind in (J.AggKind.MIN, J.AggKind.MAX)}
    for k in j:
        assert j[k].dtype == t[k].dtype, k
        if k in sums:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=0,
                                       err_msg=k)
        elif k in extrema:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        elif j[k].dtype == np.float32:
            np.testing.assert_array_equal(t[k].view(np.int32),
                                          j[k].view(np.int32), err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


_EXACT_ROWS = ("COUNT_ALL", "COUNT", "TOPK", "TOPK_DISTINCT")


def _bucket(est: np.ndarray) -> np.ndarray:
    """The histogram bucket whose geometric midpoint `est` is (0 -> 0)."""
    cfg = tl.QuantileConfig()
    x = np.log(np.maximum(est.astype(np.float64), 1e-300) / cfg.min_value)
    return np.where(est == 0, 0, np.rint(x / cfg.gamma_log + 0.5))


def assert_rows(jspec, j_rows: np.ndarray, t_rows: np.ndarray):
    """Aggregate rows [rows, ...]: exact where the value is selected or
    counted, rel 1e-6 where it is float32 arithmetic."""
    row = 0
    for agg in jspec.aggs:
        w = jl.agg_width(agg)
        jr = j_rows[row:row + w].view(np.float32)
        tr = t_rows[row:row + w].view(np.float32)
        if agg.kind == J.AggKind.APPROX_QUANTILE:
            np.testing.assert_array_equal(_bucket(tr), _bucket(jr),
                                          err_msg="quantile bucket")
            np.testing.assert_allclose(tr, jr, rtol=4e-6, atol=0,
                                       err_msg=agg.kind.name)
        elif agg.kind.name in _EXACT_ROWS:
            np.testing.assert_array_equal(tr.view(np.int32),
                                          jr.view(np.int32),
                                          err_msg=agg.kind.name)
        elif agg.kind.name in ("MIN", "MAX"):   # -0.0 == +0.0, as above
            np.testing.assert_array_equal(tr, jr, err_msg=agg.kind.name)
        else:
            np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=0,
                                       err_msg=agg.kind.name)
        row += w


@pytest.mark.parametrize("win", list(WINDOWS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_step_matches_build_step_fn(win, seed):
    for jspec, _, jstate, tstate in run_steps(win, seed):
        assert_states(jspec, jstate, tstate)
    # the batches exercised what they should
    assert int(np.asarray(jstate["a6_approx_quantile"])[..., 0].sum()) > 0
    if win != "global":    # a cell with fewer records than k
        assert bool(np.isneginf(np.asarray(jstate["a8_topk"])).any())


@pytest.mark.parametrize("win", list(WINDOWS))
def test_plain_step_flushes_subnormals_as_build_step_fn(win):
    """Subnormal inputs (ROADMAP C, fixed in the port): COUNT(col) counts
    them, SUM / AVG / MIN / MAX and the quantile bin take them as a zero
    of their sign, exact against the reference (MIN / MAX by value, as
    above). The TOPK planes keep a subnormal's bits in both and rank it
    as a zero; which of the values that rank alike a plane keeps is the
    reference's unstable sort's (ROADMAP C), so they are equal flushed."""
    topk = {jl._plane_name(i, a) for i, a in enumerate(specs(win)[0].aggs)
            if a.kind in (J.AggKind.TOPK, J.AggKind.TOPK_DISTINCT)}
    for jspec, _, jstate, tstate in run_steps(win, 2, subnormals=True):
        assert_states(jspec, jstate, tstate, skip=topk)
        for k in topk:
            want = te.ftz(torch.from_numpy(np.asarray(jstate[k]).copy()))
            np.testing.assert_array_equal(te.ftz(tstate[k]).numpy(),
                                          want.numpy(), err_msg=k)
    for k, v in tstate.items():     # no subnormal left in a plane
        if v.dtype == torch.float32 and k not in topk:
            assert not bool(te.is_subnormal(v).any()), k


def test_topk_ranks_subnormals_as_zeros_like_the_reference():
    """The reference's TOPK keeps a subnormal's bits but ranks and
    de-duplicates it as the zero of its sign (its sort and its == compare
    flushed values), and so does the port: TOPK_DISTINCT of {0.0, 1e-45}
    keeps one of them, then -inf. Which one is the reference's unstable
    sort's (ROADMAP C); the port keeps the larger bits. A lone subnormal
    is kept alike."""
    out = {}
    for m, e, lat in ((J, je, jl), (T, te, tl)):
        spec = lat.LatticeSpec(
            n_keys=2, window=None,
            aggs=(m.AggSpec(m.AggKind.TOPK_DISTINCT, "td", input=e.Col("x"),
                            k=3),))
        out[m] = spec
    x = np.array([0.0, 1e-45, 1e-45, 5.0], np.float32)
    key = np.array([0, 0, 1, 1], np.int32)
    ts = np.zeros(4, np.int32)
    valid = np.ones(4, np.bool_)
    cols = {"x": x, "__null_a0": np.zeros(4, np.bool_)}
    jspec, tspec = out[J], out[T]
    agg_inputs, _ = jl.compile_agg_inputs(jspec, J.Schema.of(
        x=J.ColumnType.FLOAT))
    jst = jax.jit(jl.build_step_fn(jspec, agg_inputs))(
        jl.init_state(jspec), np.int32(-1), key, ts, valid, cols)
    tst = tl.init_state(tspec, "cpu")
    tl.step_decoded(tspec, tst, -1, torch.from_numpy(key),
                    torch.from_numpy(ts), torch.from_numpy(valid),
                    {k: torch.from_numpy(v) for k, v in cols.items()},
                    tl.step_programs(tspec, T.Schema.of(
                        x=T.ColumnType.FLOAT), None))
    want = np.asarray(jst["a0_topk_distinct"])[:, 0]
    got = tst["a0_topk_distinct"].numpy()[:, 0]
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))  # 5.0, 1e-45
    for row in (want[0], got[0]):
        assert row[0] in (0.0, np.float32(1e-45)) and np.isneginf(row[1:]).all()
    assert got[0, 0].view(np.int32) == 1               # the larger bits


@pytest.mark.parametrize("win", ["tumble", "hop"])
def test_extract_touched_matches_build_extract_touched(win):
    max_out = 40
    for jspec, tspec, jstate, tstate in run_steps(win, 7):
        jstate_after, jpacked = jl.build_extract_touched(jspec, max_out)(
            jstate)
        jpacked = np.asarray(jpacked)
        tpacked = tl.extract_touched(tspec, tstate, max_out).numpy()
        assert tpacked.shape == jpacked.shape
        assert tpacked.dtype == np.int32
        np.testing.assert_array_equal(tpacked[:3], jpacked[:3])
        assert_rows(jspec, jpacked[3:], tpacked[3:])
        assert int(jpacked[0, 0]) > 0
        assert not bool(tstate["touched"].any())
        # the touched clear is the only state change
        jstate.update(jstate_after)


def test_extract_touched_truncates_past_max_out():
    jspec, tspec, jstate, tstate = next(iter(run_steps("hop", 3)))
    n = int(np.asarray(jstate["touched"]).sum())
    assert n > 8
    _, jpacked = jl.build_extract_touched(jspec, 8)(jstate)
    tpacked = tl.extract_touched(tspec, tstate, 8).numpy()
    np.testing.assert_array_equal(tpacked[:3], np.asarray(jpacked)[:3])
    assert int(tpacked[0, 0]) == n


@pytest.mark.parametrize("win", ["tumble", "hop"])
def test_reset_only_close_matches_build_reset_slots(win):
    *_, (jspec, tspec, jstate, tstate) = run_steps(win, 4)
    W = jspec.n_slots
    for slots in ([0], [W - 1, 1], [2, 0, 1]):
        padded = tl.pad_slots(slots)
        jstate = jl.build_reset_slots(jspec)(jstate, padded)
        tl.reset_slots(tspec, tstate, padded)
        assert_states(jspec, jstate, tstate)


def test_close_rows_carry_quantile_and_topk():
    *_, (jspec, tspec, jstate, tstate) = run_steps("hop", 5)
    slots = tl.pad_slots([0, 2, 1])
    jstate, jpacked = jl.build_extract_reset_slots(jspec)(jstate, slots)
    tpacked = tl.close_slots(tspec, tstate, slots).numpy()
    jpacked = np.asarray(jpacked)
    assert tpacked.shape == jpacked.shape == (
        4, 2 + tl.out_rows(tspec), K)
    np.testing.assert_array_equal(tpacked[:, :2], jpacked[:, :2])
    for p in range(4):
        assert_rows(jspec, jpacked[p, 2:], tpacked[p, 2:])
    assert_states(jspec, jstate, tstate)
