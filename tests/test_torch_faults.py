"""The engine's fault points in the port, each fired once on the CPU.

The reference degrades a failed device dispatch, activation or fetch to
a host path and carries on (tests/test_chaos.py:399-470,
tests/test_session_device.py:556,575). The port's failure policy
(ROADMAP C, deliberate differences) raises out of the call instead, and
keeps its state: every case below checks that

- the port raises the injected fault,
- its state planes (and the host stores that shadow them) equal a clone
  taken just before the failed call, and
- the calls that follow give the reference's uninterrupted rows.

A fault that fires before a batch's step (device.dispatch,
device.session.dispatch at the step, either activation) leaves the batch
unapplied, so the caller sends it again. A fault at a close (the fused
close's device.activate, the session extract's device.session.dispatch)
fires after that batch's step: the due windows or sessions stay open,
and the failed call checked against its clone is the close cycle alone
(`close_due_windows` / `close_due_sessions`), which the next call runs.
A fault at a deferred drain (device.fetch) leaves every pending close
pending.

Each package keeps its own process-global FAULTS registry; only the
port's is armed here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hstream_tpu_torch.common.faultinject import FAULTS, InjectedFault
from test_session_device import assert_rows_close
from test_torch_join import assert_final_equal, feed, final, make
from test_torch_session import EXACT, jax, port
from torch_parity import BASE, assert_rows_equal, pair, rows_of


@pytest.fixture(autouse=True)
def _disarmed():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def _clone(planes: dict) -> dict:
    return {k: v.clone() for k, v in planes.items()}


def _assert_planes_equal(planes: dict, clone: dict) -> None:
    assert set(planes) == set(clone)
    for k, v in planes.items():
        assert torch.equal(v, clone[k]), k


def _fire(site: str, call, *args):
    """Arm `site` to fail its next hit, make the call, expect the fault."""
    FAULTS.arm(site, "fail:1")
    try:
        with pytest.raises(InjectedFault, match=site):
            call(*args)
    finally:
        FAULTS.disarm()


# ---- QueryExecutor ------------------------------------------------------------

def _window(m):
    schema = m.Schema.of(device=m.ColumnType.STRING, temp=m.ColumnType.FLOAT)
    node = m.AggregateNode(
        child=m.SourceNode("s", schema), group_keys=[m.Col("device")],
        window=m.TumblingWindow(10_000, grace_ms=0),
        aggs=[m.AggSpec(m.AggKind.COUNT_ALL, "c"),
              m.AggSpec(m.AggKind.SUM, "s", input=m.Col("temp")),
              m.AggSpec(m.AggKind.MAX, "hi", input=m.Col("temp"))],
        having=None, post_projections=[])
    return node, schema


def _window_batches(seed: int = 3, n: int = 6):
    """Row batches over 10 keys, 4 s apart: windows close every few."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        trip = [(f"d{int(k)}", float(np.round(v, 1)), b * 4000 + int(t))
                for k, v, t in zip(rng.integers(0, 10, 60),
                                   rng.normal(20, 5, 60),
                                   rng.integers(0, 3000, 60))]
        out.append(rows_of(*trip))
    return out


def _host_view(ex) -> tuple:
    return (ex.epoch, ex.watermark_abs, sorted(ex._open), ex.late_drops,
            dict(ex.close_stats), len(ex._key_rev))


def _columnar(ex, rows, ts):
    keys = np.asarray([ex.key_id_for((r["device"],)) for r in rows],
                      np.int32)
    temp = np.asarray([r["temp"] for r in rows], np.float32)
    return ex.process_columnar(keys, np.asarray(ts, np.int64),
                               {"temp": temp})


@pytest.mark.parametrize("columnar", [False, True], ids=["rows", "columnar"])
@pytest.mark.parametrize("mode", ["close", "changes"])
def test_failed_step_dispatch_raises_and_keeps_the_batch_out(mode, columnar):
    """device.dispatch (executor.py:377 in the reference) fires before
    the batch's encode: nothing of the batch reaches a plane or a host
    store, and sending it again gives the reference's rows."""
    jex, tex = pair(_window, mode)
    batches = _window_batches()
    run = _columnar if columnar else (lambda ex, r, t: ex.process(r, t))
    for rows, ts in batches[:2]:
        assert_rows_equal(jex.process(rows, ts), run(tex, rows, ts))
    clone, host = _clone(tex.state), _host_view(tex)
    _fire("device.dispatch", run, tex, *batches[2])
    _assert_planes_equal(tex.state, clone)
    assert _host_view(tex) == host
    for rows, ts in batches[2:]:
        assert_rows_equal(jex.process(rows, ts), run(tex, rows, ts))
    if mode == "changes":
        assert_rows_equal(jex.flush_changes(), tex.flush_changes())


def test_failed_fused_close_raises_and_keeps_the_windows_open():
    """device.activate at the fused close (executor.py:1166): the
    reference degrades to its per-slot close; the port raises before it
    pops a window, so the due windows stay open, and the next close
    cycle emits the reference's rows."""
    jex, tex = pair(_window, "close")
    batches = _window_batches()
    for rows, ts in batches[:2]:
        assert_rows_equal(jex.process(rows, ts), tex.process(rows, ts))
    want = []
    for rows, ts in batches[2:]:
        want.extend(jex.process(rows, ts))
    # the batch steps, then its close fails: the windows stay due
    _fire("device.activate", tex.process, *batches[2])
    due = sorted(tex._open)
    assert due and tex.close_stats["close_cycles"] == 0
    clone, host = _clone(tex.state), _host_view(tex)
    _fire("device.activate", tex.close_due_windows)
    _assert_planes_equal(tex.state, clone)
    assert _host_view(tex) == host
    got = list(tex.close_due_windows())
    assert got and sorted(tex._open) != due
    for rows, ts in batches[3:]:
        got.extend(tex.process(rows, ts))
    assert_rows_equal(want, got)


def test_failed_deferred_drain_raises_and_keeps_the_closes_pending():
    """device.fetch at the deferred-close drain (executor.py:1251): the
    packed closes stay on the device, and the next drain decodes them
    to the reference's rows."""
    jex, tex = pair(_window, "close")
    for ex in (jex, tex):
        ex.defer_close_decode = True
    for rows, ts in _window_batches():
        assert jex.process(rows, ts) == [] and tex.process(rows, ts) == []
    assert len(tex._pending_closes) == len(jex._pending_closes) > 1
    clone, pending = _clone(tex.state), len(tex._pending_closes)
    fetches = tex.close_stats["close_fetches"]
    _fire("device.fetch", tex.drain_closed)
    _assert_planes_equal(tex.state, clone)
    assert len(tex._pending_closes) == pending
    assert tex.close_stats["close_fetches"] == fetches
    assert_rows_equal(jex.drain_closed(), tex.drain_closed())
    assert not tex._pending_closes


# ---- SessionExecutor ----------------------------------------------------------

def _session_batches(seed: int = 5, n: int = 6):
    """Integral values (the device accumulators are float32) over 12
    users, gap 1 s: sessions open, merge and close across batches."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        k = rng.integers(0, 12, 40)
        t = BASE + b * 1500 + np.sort(rng.integers(0, 1200, 40))
        v = rng.integers(-50, 50, 40).astype(float)
        out.append(([{"k": f"u{int(a)}", "v": float(c)}
                     for a, c in zip(k, v)], t.tolist()))
    return out


def _arena_view(ex) -> tuple:
    dev = ex._dev
    return (ex.epoch, ex.watermark, ex.late_drops, ex._closed_wm,
            dev["mir_code"].tolist(), dev["mir_t0"].tolist(),
            dev["mir_t1"].tolist(), dev["mir_live"].tolist())


@pytest.mark.parametrize("mode", ["segment", "record"])
def test_failed_session_activation_raises_and_stays_unactivated(mode):
    """device.session.activate (session.py:977): the reference stays on
    its host engine; the port raises before any device state exists,
    and the same first batch then activates and runs."""
    t = port(EXACT, mode, gap=1000, grace=0)
    ref = jax(EXACT, gap=1000, grace=0)
    batches = _session_batches()
    _fire("device.session.activate", t.process, *batches[0])
    assert t._dev is None and not t.sessions and t.watermark < 0
    assert t.use_device_sessions and t.device_fallbacks == 0
    for rows, ts in batches:
        assert_rows_close(list(t.process(rows, ts)),
                          list(ref.process(rows, ts)))
    assert t._dev is not None


@pytest.mark.parametrize("mode", ["segment", "record"])
def test_failed_session_step_raises_and_keeps_the_arena(mode):
    """device.session.dispatch at the step (session.py:1683): raised
    before the launch, the arena and its host mirror are the pre-batch
    ones, and the batch sent again gives the reference's rows."""
    t = port(EXACT, mode, gap=1000, grace=0)
    ref = jax(EXACT, gap=1000, grace=0)
    batches = _session_batches()
    for rows, ts in batches[:3]:
        assert_rows_close(list(t.process(rows, ts)),
                          list(ref.process(rows, ts)))
    clone, view = _clone(t._dev["arena"]), _arena_view(t)
    steps = t.session_stats["step_dispatches"]
    _fire("device.session.dispatch", t.process, *batches[3])
    _assert_planes_equal(t._dev["arena"], clone)
    assert _arena_view(t) == view
    assert t.session_stats["step_dispatches"] == steps
    for rows, ts in batches[3:]:
        assert_rows_close(list(t.process(rows, ts)),
                          list(ref.process(rows, ts)))
    assert_rows_close(list(t.peek()), list(ref.peek()))


@pytest.mark.parametrize("mode", ["segment", "record"])
def test_failed_session_step_on_a_rebase_keeps_the_epoch(mode):
    """device.session.dispatch on a batch that re-anchors the epoch: the
    arena's shift rides the step launch, so the failed step leaves the
    old epoch with the unshifted arena, and the batch sent again rebases
    and gives the reference's rows."""
    t = port(EXACT, mode, gap=1000, grace=0)
    ref = jax(EXACT, gap=1000, grace=0)
    t.REBASE_THRESHOLD = 1 << 14
    batches = [([{"k": f"u{i % 3}", "v": float(i + b)} for i in range(6)],
                [BASE + b * 7000 + i * 300 for i in range(6)])
               for b in range(6)]
    for rows, ts in batches[:3]:
        assert_rows_close(list(t.process(rows, ts)),
                          list(ref.process(rows, ts)))
    assert t.epoch == BASE  # batch 3 is the first past the threshold
    clone, view = _clone(t._dev["arena"]), _arena_view(t)
    stats = dict(t.session_stats)
    _fire("device.session.dispatch", t.process, *batches[3])
    _assert_planes_equal(t._dev["arena"], clone)
    assert _arena_view(t) == view
    assert dict(t.session_stats) == stats
    assert_rows_close(list(t.process(*batches[3])),
                      list(ref.process(*batches[3])))
    assert t.epoch > BASE  # the batch sent again did rebase
    for rows, ts in batches[4:]:
        assert_rows_close(list(t.process(rows, ts)),
                          list(ref.process(rows, ts)))
    assert_rows_close(list(t.peek()), list(ref.peek()))


@pytest.mark.parametrize("mode", ["segment", "record"])
def test_failed_session_extract_raises_and_keeps_the_sessions_open(mode):
    """device.session.dispatch at the close extract (session.py:2106):
    the batch's step runs (the site's first hit passes), its extract
    fails; the due sessions stay live in the mirror, the next close
    cycle emits them, and every row matches the reference's."""
    t = port(EXACT, mode, gap=1000, grace=0)
    ref = jax(EXACT, gap=1000, grace=0)
    batches = _session_batches()
    for rows, ts in batches[:2]:
        assert_rows_close(list(t.process(rows, ts)),
                          list(ref.process(rows, ts)))
    want = []
    for rows, ts in batches[2:]:
        want.extend(ref.process(rows, ts))
    FAULTS.arm("device.session.dispatch", "fail:2")
    try:
        with pytest.raises(InjectedFault):
            t.process(*batches[2])
    finally:
        FAULTS.disarm()
    clone, view = _clone(t._dev["arena"]), _arena_view(t)
    cycles = t.session_stats["close_cycles"]
    _fire("device.session.dispatch", t.close_due_sessions)
    _assert_planes_equal(t._dev["arena"], clone)
    assert _arena_view(t) == view
    assert t.session_stats["close_cycles"] == cycles
    got = list(t.close_due_sessions())
    assert got and t.session_stats["close_cycles"] == cycles + 1
    for rows, ts in batches[3:]:
        got.extend(t.process(rows, ts))
    assert_rows_close(got, list(want))


# ---- JoinExecutor ---------------------------------------------------------------

def _join_batches(seed: int = 7, n: int = 8):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        rows = [{"k": f"k{int(i)}", "x": 1.0}
                for i in rng.integers(0, 20, 64)]
        ts = (BASE + b * 600 + rng.integers(0, 500, 64)).tolist()
        out.append((rows, ts, "l" if b % 2 else "r"))
    return out


def _stores_view(ex) -> dict:
    return {s: (st.code.tolist(), st.ts.tolist(), len(st))
            for s, st in ex._stores.items()}


def test_failed_join_activation_raises_and_keeps_the_host_stores():
    """device.activate at the device join's activation (join.py:1132):
    the reference stays on its host path; the port raises before any
    entry moves to the device, its host stores as they were, and the
    batch sent again activates the device path and gives the
    reference's final changes."""
    ref, t = make(port=False), make(port=True)
    batches = _join_batches()
    want, got = [], []
    for rows, ts, side in batches[:2]:
        want.extend(feed(ref, rows, ts, side))
        got.extend(feed(t, rows, ts, side))
    assert t._dev is None and t._inner is not None
    view, wm = _stores_view(t), t.watermark
    _fire("device.activate", feed, t, *batches[2])
    assert t._dev is None and t.use_device_join
    assert _stores_view(t) == view and t.watermark == wm
    for rows, ts, side in batches[2:]:
        want.extend(feed(ref, rows, ts, side))
        got.extend(feed(t, rows, ts, side))
    want.extend(ref.flush_changes())
    got.extend(t.flush_changes())
    assert t._dev is not None
    assert_final_equal(final(want), final(got))
