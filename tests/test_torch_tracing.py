"""Kernel-family tracing in the port, on the CPU: the dispatch observer
and the device-time sampler under `kernel_family`, the RetraceGuard
twin that counts the port's compiles, `torch_profiler`, the stage
tracer, and the device plane bytes of the three executors.

- `kernel_family` scopes: the port's QueryExecutor dispatches "step" and
  "close", SessionExecutor "session" and "close", JoinExecutor "probe"
  (and its inner executor's "close"), at the reference's sites.
- `DEVICE_TIME` armed at rate N samples every Nth dispatch per family
  into `kernel_device_ms{family}` (the wall clock on the CPU, a CUDA
  event pair on the card); disarmed it holds no state at all.
- RetraceGuard counts a kernel-library build or load and a miss of the
  program factories (`lattice.compiled`, `expr.lower`,
  `expr.launch_plan`); steady-state batches count zero, a new spec's
  first batch more.
- Plane bytes mirror tests/test_devicecost.py:63,86,114,141: exact
  against shape x itemsize, and equal to the reference's for the same
  batches.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from hstream_tpu.engine.executor import QueryExecutor as JQueryExecutor
from hstream_tpu_torch.common import tracing
from hstream_tpu_torch.common.tracing import (
    QueryTracer,
    RetraceGuard,
    current_kernel_family,
    install_recompile_counter,
    kernel_family,
    note_compile,
    torch_profiler,
    trace_span,
)
from hstream_tpu_torch.engine.kernels import build as build_mod
from hstream_tpu_torch.stats import StatsHolder
from hstream_tpu_torch.stats.devicecost import DEVICE_TIME, plane_bytes
from test_torch_join import make as join_make
from test_torch_session import EXACT, jax as jax_session, port as port_session
from torch_parity import BASE, JM, TM


@pytest.fixture(autouse=True)
def _fresh_sampler():
    DEVICE_TIME.disarm()
    DEVICE_TIME.reset()
    yield
    DEVICE_TIME.disarm()
    DEVICE_TIME.reset()


# ---- the three executors, small ------------------------------------------------

def _window_node(m, scale=None):
    schema = m.Schema.of(k=m.ColumnType.STRING, v=m.ColumnType.FLOAT)
    v = m.Col("v") if scale is None else m.BinOp("*", m.Col("v"),
                                                  m.Lit(scale))
    node = m.AggregateNode(
        child=m.SourceNode("s", schema), group_keys=[m.Col("k")],
        window=m.TumblingWindow(10_000, grace_ms=0),
        aggs=[m.AggSpec(m.AggKind.COUNT_ALL, "c"),
              m.AggSpec(m.AggKind.SUM, "s", input=v)],
        having=None, post_projections=[])
    return node, schema


def _window(scale=None):
    node, schema = _window_node(TM, scale)
    return TM.QueryExecutor(node, schema, emit_changes=False,
                            initial_keys=8, batch_capacity=256,
                            device="cpu")


def _window_batches(n, seed=0, keys=6):
    rng = np.random.default_rng(seed)
    return [([{"k": f"k{int(i)}", "v": float(j)}
              for i, j in zip(rng.integers(0, keys, 50),
                              rng.integers(0, 9, 50))],
             (BASE + b * 3000 + rng.integers(0, 2500, 50)).tolist())
            for b in range(n)]


def _session(scale=None):
    if scale is None:
        return port_session(EXACT, "record", gap=1000, grace=0)
    aggs = (lambda m: [m.AggSpec(m.AggKind.SUM, "s", input=m.BinOp(
        "*", m.Col("v"), m.Lit(scale)))])
    return port_session(aggs, "record", gap=1000, grace=0)


def _session_batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [([{"k": f"u{int(i)}", "v": float(j)}
              for i, j in zip(rng.integers(0, 8, 30),
                              rng.integers(0, 9, 30))],
             (BASE + b * 1500 + np.sort(rng.integers(0, 1200, 30))).tolist())
            for b in range(n)]


JOIN_SQL = ("SELECT l.k, COUNT(*) AS c FROM l INNER JOIN r "
            "WITHIN (INTERVAL 1 SECOND) ON l.k = r.k "
            "GROUP BY l.k, TUMBLING (INTERVAL {size} SECOND) "
            "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")


def _join(size=10):
    return join_make(JOIN_SQL.format(size=size), port=True)


def _join_batches(n, seed=2):
    rng = np.random.default_rng(seed)
    return [([{"k": f"k{int(i)}", "x": 1.0}
              for i in rng.integers(0, 10, 40)],
             (BASE + b * 1800 + rng.integers(0, 1500, 40)).tolist(),
             "l" if b % 2 else "r")
            for b in range(n)]


def _run(kind, ex, batches):
    out = []
    for b in batches:
        if kind == "join":
            rows, ts, side = b
            out.extend(ex.process(rows, ts, stream=side))
        else:
            out.extend(ex.process(*b))
    if kind == "join":
        out.extend(ex.flush_changes())
    return out


EXECUTORS = {
    "window": (_window, _window_batches, ("step", "close")),
    "session": (_session, _session_batches, ("session", "close")),
    "join": (_join, _join_batches, ("probe", "close")),
}


def _dispatches(kind, ex) -> dict[str, int]:
    """Each family's dispatches, from the executors' own counters."""
    if kind == "window":
        return {"step": ex.read_epoch - ex.close_stats["close_cycles"],
                "close": ex.close_stats["close_dispatches"]}
    if kind == "session":
        st = ex.session_stats
        return {"session": st["step_dispatches"],
                "close": st["close_dispatches"] + st["peek_dispatches"]}
    return {"probe": ex.join_stats["probe_dispatches"],
            "close": ex._inner.close_stats["close_dispatches"]}


# ---- kernel_family -----------------------------------------------------------------

def test_kernel_family_scopes_nest_and_restore():
    assert current_kernel_family() is None
    seen = []
    with kernel_family("step", lambda f, s: seen.append((f, s))):
        assert current_kernel_family() == "step"
        with kernel_family("close"):
            assert current_kernel_family() == "close"
        assert current_kernel_family() == "step"
    assert current_kernel_family() is None
    assert [f for f, _ in seen] == ["step"] and seen[0][1] >= 0.0
    with pytest.raises(ValueError):
        with kernel_family("probe"):
            raise ValueError("the body's error passes through")
    assert current_kernel_family() is None


@pytest.mark.parametrize("kind", sorted(EXECUTORS))
def test_dispatch_observer_sees_every_dispatch_by_family(kind):
    build, batches, families = EXECUTORS[kind]
    ex = build()
    seen: list[str] = []
    obs = (lambda fam, s: seen.append(fam))
    ex.dispatch_observer = obs
    if kind == "join":
        _run(kind, ex, batches(3))  # the inner executor comes first
        ex._inner.dispatch_observer = obs
        seen.clear()
        base = _dispatches(kind, ex)
        _run(kind, ex, batches(8, seed=9)[3:])
        now = _dispatches(kind, ex)
        want = {f: now[f] - base[f] for f in families}
    else:
        _run(kind, ex, batches(6))
        if kind == "session":
            ex.peek()
        want = _dispatches(kind, ex)
    assert {f: seen.count(f) for f in families} == want
    assert want[families[0]] > 0 and want["close"] > 0
    assert set(seen) <= set(families) | {"step"}


@pytest.mark.parametrize("rate", [1, 2, 3])
@pytest.mark.parametrize("kind", sorted(EXECUTORS))
def test_armed_sampler_records_every_nth_dispatch(kind, rate):
    build, batches, families = EXECUTORS[kind]
    ex = build()
    stats = StatsHolder()
    DEVICE_TIME.add_sink(stats)
    DEVICE_TIME.arm(rate)
    _run(kind, ex, batches(7))
    DEVICE_TIME.disarm()
    counts = DEVICE_TIME.state()["counts"]
    samples = DEVICE_TIME.state()["samples"]
    hists = stats.histograms_snapshot()
    disp = _dispatches(kind, ex)
    for fam in families:
        assert counts[fam] == disp[fam] > 0, fam
        assert samples.get(fam, 0) == disp[fam] // rate, fam
        if disp[fam] >= rate:
            assert hists[("kernel_device_ms", fam)].count == \
                disp[fam] // rate
            assert all(ms >= 0.0 for ms in DEVICE_TIME.samples(fam))
    pct = DEVICE_TIME.percentiles()
    for fam, row in pct.items():
        assert row["count"] == samples[fam] and row["p50"] <= row["p99"]


@pytest.mark.parametrize("kind", sorted(EXECUTORS))
def test_disarmed_sampler_holds_no_state(kind):
    build, batches, _families = EXECUTORS[kind]
    _run(kind, build(), batches(6))
    assert DEVICE_TIME.state() == {"counts": {}, "samples": {}}
    assert DEVICE_TIME.percentiles() == {}


def test_sampler_measures_the_wall_clock_on_the_cpu():
    DEVICE_TIME.arm(1)
    planes = {"a": torch.zeros(4)}
    with kernel_family("step", ready=lambda: planes):
        time.sleep(0.002)
    with kernel_family("close", ready=lambda: ()):  # no tensor: wall too
        pass
    (ms,) = DEVICE_TIME.samples("step")
    assert ms >= 2.0
    assert len(DEVICE_TIME.samples("close")) == 1


# ---- RetraceGuard ------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(EXECUTORS))
def test_steady_state_batches_compile_nothing(kind):
    build, batches, _families = EXECUTORS[kind]
    ex = build()
    warm, steady = batches(12)[:5], batches(12)[5:]
    _run(kind, ex, warm)
    with RetraceGuard() as g:
        out = _run(kind, ex, steady)
    assert g.count == 0
    assert out


@pytest.mark.parametrize("kind", sorted(EXECUTORS))
def test_a_new_specs_first_batch_compiles(kind):
    """A spec no earlier test in the process built (a literal, or a
    window size, of its own) misses the program factories."""
    build, batches, _families = EXECUTORS[kind]
    fresh = 17 + (time.perf_counter_ns() % 1000)
    with RetraceGuard() as g:
        if kind == "join":
            ex = build(size=fresh)
            _run(kind, ex, batches(4))
        else:
            ex = build(scale=fresh / 7.0)
            _run(kind, ex, batches(1))
    assert g.count > 0


def test_compiles_land_in_the_stats_sinks_by_stream_and_family():
    stats = StatsHolder()
    install_recompile_counter(stats, "_t")
    install_recompile_counter(stats, "_t")  # idempotent
    with RetraceGuard() as g:
        with kernel_family("step"):
            note_compile()
        with RetraceGuard(name="q1") as named:
            note_compile()
    assert g.count == 2 and named.count == 1
    assert stats.stream_stat_get("kernel_recompiles", "_t") == 1
    assert stats.stream_stat_get("kernel_recompiles", "q1") == 1
    assert stats.stream_stat_get("factory_recompiles", "step") == 1
    with RetraceGuard() as after:
        pass
    assert after.count == 0


def test_the_kernel_library_counts_once_a_process(monkeypatch, tmp_path):
    """build()'s first call counts one compile, built or found; later
    calls count nothing (the library here is a stand-in file: the CPU
    has no nvcc)."""
    monkeypatch.setattr(build_mod, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build_mod, "_noted", False)
    lib = tmp_path / f"libhs_kernels_{build_mod._digest()}.so"
    lib.write_bytes(b"")
    with RetraceGuard() as g:
        first = build_mod.build()
        second = build_mod.build()
    assert first.path == second.path == str(lib)
    assert g.count == 1


def test_a_factory_hit_is_no_compile():
    from hstream_tpu_torch.engine import expr as texpr
    from hstream_tpu_torch.engine.types import ColumnType, Schema

    schema = Schema.of(v=ColumnType.FLOAT)
    prog = texpr.compile_device(
        texpr.BinOp("+", texpr.Col("v"), texpr.Lit(0.321)), schema)
    with RetraceGuard() as g:
        texpr.lower(prog)
        texpr.launch_plan(((prog, "o"),))
    with RetraceGuard() as g2:
        texpr.lower(prog)
        texpr.launch_plan(((prog, "o"),))
    assert g.count >= 1 and g2.count == 0


# ---- torch_profiler and the stage tracer ---------------------------------------------

def test_torch_profiler_writes_a_trace(tmp_path):
    out = str(tmp_path / "prof")
    with torch_profiler(out) as prof:
        torch.arange(128, dtype=torch.float32).sum()
    assert prof is not None
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(out) for f in fs]
    assert files, "profiler produced no trace files"
    with open(files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_tracer_summary():
    tr = QueryTracer(capacity=4)
    for ms in (1, 2, 3, 10):
        tr.record("step", ms / 1e3)
    s = tr.summary()["step"]
    assert s["count"] == 4
    assert s["total_ms"] == pytest.approx(16.0, rel=0.01)
    assert s["p50_ms"] == pytest.approx(3.0, rel=0.01)
    with trace_span(tr, "emit"):
        time.sleep(0.003)
    assert tr.summary()["emit"]["count"] == 1
    assert tr.summary()["emit"]["mean_ms"] >= 2.0
    with trace_span(None, "noop"):  # tracer-less spans are free
        pass


def test_span_collector_samples_and_exports_like_the_reference():
    from hstream_tpu.common import tracing as jtracing

    for mod in (tracing, jtracing):
        col = mod.SpanCollector(0.5, ring_capacity=2, max_scopes=2)
        ids = [f"req-{i}" for i in range(200)]
        picks = [col.sampled(i) for i in ids]
        assert 40 < sum(picks) < 160
        for s in ("a", "b", "c"):
            for j in range(3):
                col.record_span(s, "rpc", trace_id="t", span_id=f"{j}",
                                t0_ms=1.0, dur_ms=0.5)
        assert col.scopes() == ["b", "c"]
        assert len(col.spans("c")) == 2
        ev = col.export_chrome("c")["traceEvents"]
        assert [e["name"] for e in ev] == ["rpc", "rpc"]
    assert ([tracing.SpanCollector(0.5).sampled(i) for i in ids]
            == [jtracing.SpanCollector(0.5).sampled(i) for i in ids])
    assert tracing.KERNEL_FAMILIES == jtracing.KERNEL_FAMILIES
    assert tracing.TRACE_STAGES == jtracing.TRACE_STAGES


# ---- plane bytes (tests/test_devicecost.py:63,86,114,141) -----------------------------

def _brute_bytes(planes) -> dict[str, int]:
    out: dict[str, int] = {}
    for name, arr in dict(planes).items():
        n = 1
        for d in arr.shape:
            n *= int(d)
        nb = n * np.dtype(str(arr.dtype).replace("torch.", "")).itemsize
        if nb:
            out[str(name)] = nb
    return out


def test_fixed_window_plane_bytes_exact_across_grow():
    node, schema = _window_node(JM)
    ref = JQueryExecutor(node, schema, emit_changes=False, initial_keys=8,
                         batch_capacity=256)
    ex = _window()
    rows = [{"k": f"k{i % 4}", "v": 1.0} for i in range(16)]
    for e in (ref, ex):
        e.process(rows, [BASE + i for i in range(16)])
    got = ex.device_plane_bytes()
    assert got == _brute_bytes(ex.state) == ref.device_plane_bytes()
    before = sum(got.values())
    rows = [{"k": f"g{i}", "v": 1.0} for i in range(50)]
    for e in (ref, ex):
        e.process(rows, [BASE + i for i in range(50)])
    got2 = ex.device_plane_bytes()
    assert got2 == _brute_bytes(ex.state) == ref.device_plane_bytes()
    assert sum(got2.values()) > before


def test_join_plane_bytes_exact_with_prefixed_planes():
    ref, ex = (join_make(JOIN_SQL.format(size=10), port=p)
               for p in (False, True))
    rng = np.random.default_rng(5)
    for b in range(8):
        rows = [{"k": f"k{int(i)}", "x": 1.0}
                for i in rng.integers(0, 30, 128)]
        ts = (BASE + b * 500
              + rng.integers(0, 400, 128).astype(np.int64)).tolist()
        for e in (ref, ex):
            e.process(rows, ts, stream="l" if b % 2 else "r")
    assert ex._dev is not None, "device join path did not activate"
    want = {f"agg.{k}": v for k, v in _brute_bytes(ex._inner.state).items()}
    for side in ("l", "r"):
        for k, v in _brute_bytes(ex._dev["stores"][side]).items():
            want[f"{side}.{k}"] = v
    got = ex.device_plane_bytes()
    assert got == want == ref.device_plane_bytes()
    assert {p.split(".", 1)[0] for p in got} >= {"l", "r", "agg"}


@pytest.mark.parametrize("mode", ["segment", "record"])
def test_session_plane_bytes_exact_across_compaction(mode):
    """The port keeps two arenas (the step writes the spare, then they
    swap): its bytes are the reference's one arena twice over."""
    ex = port_session(EXACT, mode, gap=500, grace=0)
    ref = jax_session(EXACT, mode, device=True, gap=500, grace=0)
    assert ex.device_plane_bytes() == {}
    for e in (ex, ref):
        e._KEY_CACHE_MAX = 64
    rng = np.random.default_rng(3)
    seen = False
    for b in range(8):
        ks = [f"k{b}_{int(i)}" for i in rng.integers(0, 40, 120)]
        ts = (BASE + b * 5000 + rng.integers(0, 400, 120)).tolist()
        for e in (ex, ref):
            e.process([{"k": k, "v": 1.0} for k in ks], ts)
        if ex._dev is not None:
            got = ex.device_plane_bytes()
            arena = _brute_bytes(ex._dev["arena"])
            assert got == {k: 2 * v for k, v in arena.items()}
            assert arena == ref.device_plane_bytes()
            seen = True
    assert seen and ex.session_stats["remap_dispatches"] >= 1


def test_plane_bytes_skips_non_tensors_and_empty():
    got = plane_bytes({"a": torch.zeros((4, 2), dtype=torch.float32),
                       "empty": torch.zeros((0,), dtype=torch.int32),
                       "scalarish": 7})
    assert got == {"a": 32}
