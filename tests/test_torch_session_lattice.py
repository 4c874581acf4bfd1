"""The port's session programs (hstream_tpu_torch/engine/session_lattice.py)
against the JAX package's (hstream_tpu/engine/lattice.py session kernels)
on JAX's CPU backend, on the same numpy inputs.

The port's functions here are the plain PyTorch versions the CUDA kernels
are held against on the card (chip_smoke.py). Tolerances: code, t0, t1,
integer planes, HLL registers and histograms exact; MIN/MAX planes by
value (+0.0 vs -0.0 depends on update order in both engines); SUM/AVG
planes exact on small-integer inputs, else rel 1e-6 (the reference adds
in XLA's order); a finalized quantile rel 4e-6 (the same bucket's
midpoint: XLA contracts the exp's argument into an FMA, see
tests/test_torch_changelog_lattice.py); every other extract row exact.
The chain assignment is held exactly: the port sorts by (code, start)
only, and a run of equal starts can break a chain only at its first
entry, so the slots equal the reference's (code, start, end) sort's.
"""

from __future__ import annotations

import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hstream_tpu.engine import lattice as JL
from hstream_tpu_torch.engine import session_lattice as sl
from hstream_tpu_torch.engine.expr import columns_of
from hstream_tpu_torch.engine.kernels import binding as kb
from torch_parity import JM, TM

GAP = 100
CAP = 256


def _aggs(m):
    """Every session aggregate kind over a float, an int, a bool and a
    computed input; p50 and p99 share one histogram."""
    v, w, b = m.Col("v"), m.Col("w"), m.Col("b")
    A, S = m.AggKind, m.AggSpec
    return (S(A.COUNT_ALL, "c"), S(A.COUNT, "n", input=v),
            S(A.SUM, "s", input=v), S(A.AVG, "a", input=v),
            S(A.MIN, "lo", input=v), S(A.MAX, "hi", input=v),
            S(A.APPROX_COUNT_DISTINCT, "d", input=v),
            S(A.APPROX_QUANTILE, "p50", input=v, quantile=0.5),
            S(A.APPROX_QUANTILE, "p99", input=v, quantile=0.99),
            S(A.COUNT, "nw", input=w), S(A.MAX, "whi", input=w),
            S(A.SUM, "sx", input=m.BinOp("+", m.BinOp("*", v, m.Lit(2.0)),
                                         w)),
            S(A.APPROX_COUNT_DISTINCT, "db", input=b))


def _schema(m):
    return m.Schema.of(v=m.ColumnType.FLOAT, w=m.ColumnType.INT,
                       b=m.ColumnType.BOOL)


JSPEC = JL.SessionSpec(aggs=_aggs(JM))
TSPEC = sl.SessionSpec(aggs=_aggs(TM))
JSCHEMA, TSCHEMA = _schema(JM), _schema(TM)
LAYOUT = (("b", "bool"), ("v", "f32"), ("w", "i32"))
SUMS = {n for n, a in zip(sl.session_plane_names(TSPEC), TSPEC.aggs)
        if a.kind in (TM.AggKind.SUM, TM.AggKind.AVG)}


def _batch(seed, n, n_codes, t_lo, integral=True):
    """A packed batch (numpy) with out-of-order records, equal starts,
    consecutive records exactly GAP and GAP + 1 apart, invalid records,
    NULL masks and (unless integral) NaN, +-inf and fractional values."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_codes, n)
    steps = np.array([0, 1, GAP, GAP + 1, 3 * GAP])
    order = np.argsort(codes, kind="stable")
    first = np.ones(n, bool)
    first[1:] = codes[order][1:] != codes[order][:-1]
    step = steps[rng.integers(0, len(steps), n)]
    step[first] = rng.integers(0, 10 * GAP, int(first.sum()))
    csum = np.cumsum(step)
    ts = np.empty(n, np.int64)
    ts[order] = t_lo + csum - np.maximum.accumulate(
        np.where(first, csum - step, 0))
    v = rng.integers(-50, 200, n).astype(np.float32)
    if not integral:
        v = v * np.float32(0.37)
        v[::17] = np.array([np.nan, np.inf, -np.inf, -0.0],
                           np.float32)[rng.integers(0, 4, len(v[::17]))]
    w = rng.integers(-40, 40, n).astype(np.int32)
    b = rng.random(n) < 0.5
    valid = rng.random(n) > 0.05
    nulls = {c: rng.random(n) < 0.08 for c in "vwb"}
    masks = []
    for a in _aggs(TM):
        if a.input is not None:
            m = np.zeros(n, bool)
            for c in columns_of(a.input):
                m |= nulls[c]
            masks.append(m)
    return JL.pack_batch_host(n, n, codes.astype(np.int32), ts, valid,
                              {"v": v, "w": w, "b": b}, masks, LAYOUT)


def _jax_step(arena, packed, close_cut, delta):
    step = JL.session_step_kernel(JSPEC, JSCHEMA, LAYOUT, CAP,
                                  packed.shape[1])
    out = step({k: jnp.asarray(v) for k, v in arena.items()},
               jnp.asarray(packed), np.int32(GAP), np.int32(close_cut),
               np.int32(delta))
    return {k: np.array(v) for k, v in out.items()}


def _port_step(arena, packed, close_cut, delta):
    t = {k: torch.from_numpy(v.copy()) for k, v in arena.items()}
    out = sl.init_session_arena(TSPEC, CAP, "cpu")
    p = torch.from_numpy(packed.copy())
    inputs = sl.session_inputs(TSPEC, LAYOUT, p,
                               sl.session_programs(TSPEC, TSCHEMA))
    before = sl.session_step.launches
    sl.session_step(TSPEC, t, out, p, inputs, GAP, close_cut, delta)
    assert sl.session_step.launches == before  # the CPU runs the plain one
    return {k: v.numpy() for k, v in out.items()}


def _assert_arenas(got, want, exact_sums):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in SUMS and not exact_sums:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        elif g.dtype == np.float32:
            assert np.array_equal(g, w), k        # by value (+-0.0)
        else:
            assert np.array_equal(g, w), k


@pytest.fixture(scope="module")
def base_arena():
    """An arena made by the reference's step from an empty one, then
    evicted entries (sentinel codes) between live ones."""
    empty = JL.session_plane_np(JSPEC, CAP)
    a = _jax_step(empty, _batch(1, 512, 12, 0), -(1 << 30), 0)
    live = np.nonzero(a["code"] < JL.SESSION_SENT_CODE)[0]
    assert 30 < len(live) < CAP
    a["code"][live[::9]] = JL.SESSION_SENT_CODE
    return a


def test_arena_planes_match_the_reference():
    want = JL.session_plane_np(JSPEC, 64)
    got = sl.session_plane_np(TSPEC, 64)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    assert sl.session_plane_names(TSPEC) == JL.session_plane_names(JSPEC)
    assert sl.SESSION_SENT_CODE == JL.SESSION_SENT_CODE == 1 << 22
    assert sl._SESSION_NEG == JL._SESSION_NEG
    grown = sl.grow_session_arena(TSPEC, sl.init_session_arena(
        TSPEC, 64, "cpu"), 128)
    for k, v in JL.session_plane_np(JSPEC, 128).items():
        assert np.array_equal(grown[k].numpy(), v), k


@pytest.mark.parametrize("integral", [True, False])
def test_step_matches_reference(base_arena, integral):
    """Every kind (incl. a computed input), NULL masks, retired entries
    (t1 <= close_cut) and a non-zero delta."""
    live_t1 = np.sort(base_arena["t1"][base_arena["code"]
                                       < JL.SESSION_SENT_CODE])
    close_cut = int(live_t1[len(live_t1) // 3])  # an entry's own t1
    packed = _batch(2, 512, 12, 800, integral)
    want = _jax_step(base_arena, packed, close_cut, 37)
    got = _port_step(base_arena, packed, close_cut, 37)
    retired = (base_arena["code"] < JL.SESSION_SENT_CODE) & \
        (base_arena["t1"] <= close_cut)
    assert retired.any() and (base_arena["t1"][retired] == close_cut).any()
    _assert_arenas(got, want, exact_sums=integral)


def test_step_from_empty_arena_and_empty_batch(base_arena):
    empty = JL.session_plane_np(JSPEC, CAP)
    packed = _batch(3, 512, 12, 0)
    _assert_arenas(_port_step(empty, packed, -(1 << 30), 0),
                   _jax_step(empty, packed, -(1 << 30), 0), True)
    nothing = packed.copy()
    nothing[2] = 0                      # no valid record
    _assert_arenas(_port_step(base_arena, nothing, -(1 << 30), 0),
                   _jax_step(base_arena, nothing, -(1 << 30), 0), True)


def _segments(seed, nseg, n_codes, t_lo):
    rng = np.random.default_rng(seed)
    seg = JL.session_plane_np(JSPEC, nseg)
    seg["code"][:] = rng.integers(0, n_codes, nseg)
    seg["code"][rng.random(nseg) < 0.1] = JL.SESSION_SENT_CODE
    t0 = t_lo + rng.integers(0, 20 * GAP, nseg)
    seg["t0"][:] = t0
    seg["t1"][:] = t0 + rng.choice([0, 1, GAP, GAP + 1], nseg)
    for name, a in zip(JL.session_plane_names(JSPEC), JSPEC.aggs):
        p = seg[name]
        if a.kind in (JM.AggKind.COUNT_ALL, JM.AggKind.COUNT):
            p[:] = rng.integers(0, 20, nseg)
        elif a.kind in (JM.AggKind.SUM, JM.AggKind.AVG):
            p[:] = rng.integers(-100, 100, nseg)
            if a.kind == JM.AggKind.AVG:
                seg[name + "_n"][:] = rng.integers(0, 20, nseg)
        elif a.kind in (JM.AggKind.MIN, JM.AggKind.MAX):
            p[:] = rng.integers(-100, 100, nseg)
            p[rng.random(nseg) < 0.2] = (np.inf if a.kind == JM.AggKind.MIN
                                         else -np.inf)
        elif a.kind == JM.AggKind.APPROX_COUNT_DISTINCT:
            hit = rng.random(p.shape) < 0.05
            p[hit] = rng.integers(1, 23, int(hit.sum()))
        else:
            hit = rng.random(p.shape) < 0.05
            p[hit] = rng.integers(1, 5, int(hit.sum()))
    return seg


def test_merge_matches_reference(base_arena):
    live_t1 = base_arena["t1"][base_arena["code"] < JL.SESSION_SENT_CODE]
    close_cut = int(np.quantile(live_t1, 0.25))
    seg = _segments(4, 128, 12, 600)
    merge = JL.session_merge_kernel(JSPEC, CAP, 128)
    want = {k: np.asarray(v) for k, v in merge(
        {k: jnp.asarray(v) for k, v in base_arena.items()},
        {k: jnp.asarray(v) for k, v in seg.items()}, np.int32(GAP),
        np.int32(close_cut), np.int32(11)).items()}
    out = sl.init_session_arena(TSPEC, CAP, "cpu")
    sl.session_merge(TSPEC, {k: torch.from_numpy(v.copy())
                             for k, v in base_arena.items()}, out,
                     {k: torch.from_numpy(v) for k, v in seg.items()},
                     GAP, close_cut, 11)
    _assert_arenas({k: v.numpy() for k, v in out.items()}, want, True)


def test_extract_matches_reference(base_arena):
    """-1 pads, empty histograms (0.0, not the top bucket), +-inf
    MIN/MAX (0.0), AVG with n = 0, HLL as rint(estimate)."""
    a = {k: v.copy() for k, v in base_arena.items()}
    rng = np.random.default_rng(5)
    names = JL.session_plane_names(JSPEC)
    hll = a[names[6]]
    hll[:] = np.where(rng.random(hll.shape) < rng.random((CAP, 1)),
                      rng.integers(1, 12, hll.shape), 0)
    a[names[7]][::3] = 0                 # empty histograms
    a[names[3] + "_n"][::4] = 0
    slots = JL.pad_slots(rng.permutation(CAP)[:150].astype(np.int32))
    assert (slots < 0).any()
    ext = JL.session_extract_kernel(JSPEC, CAP, len(slots))
    want = np.asarray(ext({k: jnp.asarray(v) for k, v in a.items()},
                          jnp.asarray(slots)))
    got = sl.session_extract(TSPEC, {k: torch.from_numpy(v)
                                     for k, v in a.items()}, slots).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    for r, agg in enumerate((None,) + TSPEC.aggs):
        if agg is not None and agg.kind == TM.AggKind.APPROX_QUANTILE:
            np.testing.assert_allclose(got[r].view(np.float32),
                                       want[r].view(np.float32), rtol=4e-6)
        elif agg is not None and agg.kind in (TM.AggKind.SUM,
                                              TM.AggKind.AVG):
            np.testing.assert_allclose(got[r].view(np.float32),
                                       want[r].view(np.float32), rtol=1e-6)
        else:
            assert np.array_equal(got[r], want[r]), r
    empty_q = got[8][: len(slots)][(slots >= 0)
                                   & (np.arange(len(slots)) < len(slots))]
    assert (empty_q.view(np.float32) == 0).any()


def test_remap_matches_reference():
    rng = np.random.default_rng(6)
    lcap = 64
    code = rng.integers(0, 2 * lcap, CAP).astype(np.int32)
    code[::5] = lcap
    code[::7] = JL.SESSION_SENT_CODE
    lut = rng.permutation(lcap).astype(np.int32)
    lut[::3] = JL.SESSION_SENT_CODE
    arena = JL.session_plane_np(JSPEC, CAP)
    arena["code"] = code
    remap = JL.session_remap_kernel(CAP, lcap)
    want = np.asarray(remap({k: jnp.asarray(v) for k, v in arena.items()},
                            jnp.asarray(lut))["code"])
    t = {"code": torch.from_numpy(code.copy())}
    sl.session_remap(t, torch.from_numpy(lut))
    assert np.array_equal(t["code"].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_slots_match_reference_under_ties(seed):
    """Adversarial ties: many equal (code, start) with different ends,
    starts exactly gap and gap + 1 past the running end, sentinels
    (which sort last) mixed in."""
    rng = np.random.default_rng(seed)
    m = 400
    code = rng.integers(0, 6, m).astype(np.int32)
    code[rng.random(m) < 0.15] = JL.SESSION_SENT_CODE
    start = (rng.integers(0, 12, m) * GAP // 2).astype(np.int32)
    end = start + rng.choice([0, 1, GAP, GAP + 1, 2 * GAP], m).astype(
        np.int32)
    want = np.asarray(JL._session_chain_slots(
        jnp.asarray(code), jnp.asarray(start), jnp.asarray(end),
        np.int32(GAP), 300))
    got = sl.chain_slots(torch.from_numpy(code), torch.from_numpy(start),
                         torch.from_numpy(end), GAP, 300).numpy()
    assert np.array_equal(got, want)
    assert (got == 300).sum() >= (code == JL.SESSION_SENT_CODE).sum()


def test_pack_and_unpack_match_reference():
    rng = np.random.default_rng(7)
    n = 100
    cols = {"v": rng.normal(size=n).astype(np.float32),
            "w": rng.integers(-5, 5, n).astype(np.int32),
            "b": rng.random(n) < 0.5}
    masks = [rng.random(n) < 0.2, None, rng.random(n) < 0.3]
    valid = rng.random(n) < 0.9
    args = (128, n, rng.integers(0, 9, n).astype(np.int32),
            rng.integers(0, 1000, n), valid, cols, masks, LAYOUT)
    want = JL.pack_batch_host(*args)
    got = sl.pack_batch_host(*args)
    assert np.array_equal(got, want)
    buf = np.full_like(want, 7)
    assert np.array_equal(sl.pack_batch_host(*args, out=buf), want)
    nk = ("__null_a0", None, "__null_a2")
    jk, jts, jvalid, jcols = JL.unpack_batch_device(jnp.asarray(want),
                                                    LAYOUT, nk)
    tk, tts, tvalid, tcols = sl.unpack_batch(torch.from_numpy(want),
                                             LAYOUT, nk)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tts.numpy(), np.asarray(jts))
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert set(tcols) == set(jcols)
    for k in jcols:
        assert np.array_equal(tcols[k].numpy(), np.asarray(jcols[k])), k


_CTYPE_OF = {"int32_t": (ctypes.c_int32,), "int64_t": (ctypes.c_int64,),
             "uint32_t": (ctypes.c_uint32,), "float": (ctypes.c_float,)}


def _macro(expr: str, text: str) -> int:
    """The value of an integer #define expression of the header."""
    defs = dict(re.findall(r"#define (\w+) ([^\n]+)", text))
    while True:
        names = [t for t in re.findall(r"[A-Za-z_]\w*", expr)]
        if not names:
            return int(eval(expr, {"__builtins__": {}}))
        for t in names:
            expr = re.sub(rf"\b{t}\b", f"({defs[t]})", expr)


def _header_structs() -> dict[str, list[tuple[str, str, int]]]:
    """{struct: [(field, C type, array length)]} from hs_kernels.h."""
    path = (pathlib.Path(sl.__file__).parent / "kernels" / "csrc"
            / "hs_kernels.h")
    text = re.sub(r"//[^\n]*", "", path.read_text())
    out = {}
    for name, body in re.findall(r"struct (\w+) \{(.*?)\};", text, re.S):
        fields = []
        for decl in body.split(";"):
            decl = decl.strip()
            if not decl:
                continue
            mm = re.match(r"(?:const )?(\w+)\s*(\*?)\s*(\w+)(?:\[(\w+)\])?$",
                          decl)
            assert mm, decl
            ctype, star, fname, arr = mm.groups()
            n = 1 if arr is None else _macro(arr, text)
            fields.append((fname, ctype + star, n))
        out[name] = fields
    return out


def test_binding_structs_mirror_the_header():
    """Every ctypes structure in binding.py lays out its header struct's
    fields in the same order, with matching types and array lengths."""
    structs = _header_structs()
    py = {"HsStream": kb.Stream, "HsDecodeArgs": kb.DecodeArgs,
          "HsExprOp": kb.ExprOp, "HsExprProg": kb.ExprProg,
          "HsExprArgs": kb.ExprArgs, "HsScatterAgg": kb.ScatterAgg,
          "HsDivisor": kb.Divisor,
          "HsScatterArgs": kb.ScatterArgs, "HsCloseAgg": kb.CloseAgg,
          "HsFinalize": kb.Finalize, "HsCloseArgs": kb.CloseArgs,
          "HsTouchedArgs": kb.TouchedArgs, "HsUnpackArgs": kb.UnpackArgs,
          "HsSessPlane": kb.SessPlane,
          "HsSessionArgs": kb.SessionArgs,
          "HsSessExtractArgs": kb.SessExtractArgs,
          "HsJoinRef": kb.JoinRef, "HsJoinFeedCol": kb.JoinFeedCol,
          "HsJoinNull": kb.JoinNull, "HsJoinProbeArgs": kb.JoinProbeArgs,
          "HsJoinInsertArgs": kb.JoinInsertArgs,
          "HsJoinEvictSide": kb.JoinEvictSide,
          "HsJoinEvictArgs": kb.JoinEvictArgs}
    assert set(structs) == set(py)
    for cname, fields in structs.items():
        cls = py[cname]
        assert [f for f, _t, _n in fields] == [f for f, _t in cls._fields_], \
            cname
        for (fname, ctype, n), (_f, pytype) in zip(fields, cls._fields_):
            base = pytype
            if n > 1:
                assert issubclass(pytype, ctypes.Array) and \
                    pytype._length_ == n, (cname, fname)
                base = pytype._type_
            if ctype.endswith("*"):
                assert base is ctypes.c_void_p, (cname, fname)
            elif ctype in _CTYPE_OF:
                assert base in _CTYPE_OF[ctype], (cname, fname)
            else:
                assert base.__name__ == py[ctype].__name__, (cname, fname)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """Checks the wrappers make before any launch (run here on CPU
    tensors where they apply to both devices; the plane check, which
    guards the kernels' pointers, directly)."""
    arena = sl.init_session_arena(TSPEC, 8, "cpu")
    with pytest.raises(ValueError, match="out of range"):
        sl.session_extract(TSPEC, arena, np.array([0, 8], np.int32))
    with pytest.raises(ValueError, match="int32"):
        sl.session_remap(arena, torch.zeros(4, dtype=torch.int64))
    dev = torch.device("cpu")
    sl._check_arena(TSPEC, arena, 8, dev)
    hll = sl.session_plane_names(TSPEC)[6]
    bad = [dict(arena, **{hll: arena[hll][:, :512].contiguous()}),
           dict(arena, **{hll: arena[hll].to(torch.int32)}),
           {k: v for k, v in arena.items() if k != "t1"},
           dict(arena, code=arena["code"][:4])]
    for b in bad:
        with pytest.raises(ValueError, match="session arena plane"):
            sl._check_arena(TSPEC, b, 8, dev)
