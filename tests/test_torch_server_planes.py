"""The server's planes through both packages: the subscription ack
window (tests/test_subscriptions.py), the read plane's cache, staleness
bound, closed-only path and fan-out (tests/test_read_plane.py, without
test_pull_query_cached_end_to_end, which is flaky in the reference) and
the server cases of tests/test_flow.py. Each case
runs once against the JAX package's modules and once against the port's
(`p`, parametrised); the port's contexts run on the CPU."""

import importlib
import json
import random
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from torch_server import BASE, PACKAGES, Pair, poll

_MODS = {
    "subscriptions": "server.subscriptions", "readcache": "server.readcache",
    "views": "server.views", "context": "server.context", "store": "store",
    "locktrace": "common.locktrace", "columnar": "common.columnar",
    "rec": "common.records", "pb": "proto.api_pb2", "flow": "flow",
    "errors": "common.errors", "codegen": "sql.codegen", "engine": "engine",
    "expr": "engine.expr",
}


def _package(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in _MODS.items()})
    cpu = {"device": "cpu"} if root.endswith("_torch") else {}
    ns.cpu = cpu

    def context(uri="mem://", **kw):
        return ns.context.ServerContext(ns.store.open_store(uri), **kw, **cpu)

    ns.new_context = context
    return ns


@pytest.fixture(params=PACKAGES)
def p(request):
    return _package(request.param)


# ---- the ack window -----------------------------------------------------------

def _deliver(win, batches):
    for lsn, size in batches:
        win.note_batch(lsn, size)


def _ids(p, batches):
    return [p.subscriptions.RecId(lsn, i) for lsn, size in batches
            for i in range(size)]


def test_ack_window_cases(p):
    AckWindow, RecId = p.subscriptions.AckWindow, p.subscriptions.RecId
    # in-order acks commit everything
    win = AckWindow()
    _deliver(win, [(1, 3), (2, 1), (3, 2)])
    for rid in _ids(p, [(1, 3), (2, 1), (3, 2)]):
        win.ack(rid)
    assert win.advance() == 3 and win.ranges == []
    # out-of-order acks commit only the prefix
    win = AckWindow()
    _deliver(win, [(1, 2), (2, 2)])
    win.ack(RecId(2, 0))
    win.ack(RecId(2, 1))
    assert win.advance() is None
    win.ack(RecId(1, 1))
    assert win.advance() is None
    win.ack(RecId(1, 0))
    assert win.advance() == 2
    # a trim gap counts as acknowledged
    win = AckWindow()
    win.note_batch(1, 1)
    win.ack(RecId(1, 0))
    win.note_gap(2, 5)
    win.note_batch(6, 1)
    win.ack(RecId(6, 0))
    assert win.advance() == 6
    # a partly acknowledged batch commits the previous LSN
    win = AckWindow()
    _deliver(win, [(1, 1), (2, 3)])
    for rid in (RecId(1, 0), RecId(2, 0), RecId(2, 1)):
        win.ack(rid)
    assert win.advance() == 1
    # the successor of an unknown LSN defers
    win = AckWindow()
    win.note_batch(1, 1)
    win.ack(RecId(1, 0))
    assert win.advance() == 1
    win.note_batch(2, 2)
    win.ack(RecId(2, 1))
    assert win.advance() is None
    win.ack(RecId(2, 0))
    assert win.advance() == 2


@pytest.mark.parametrize("seed", [42, 7])
def test_ack_window_random_orders_agree_across_packages(seed):
    """Random ack permutations and interleavings of delivery with acks:
    both packages commit the same LSN after every ack, and exactly the
    fully acknowledged prefix."""
    ref, port = (_package(r).subscriptions for r in PACKAGES)
    rng = random.Random(seed)
    for trial in range(40):
        n = rng.randint(1, 8)
        batches = [(lsn, rng.randint(1, 4)) for lsn in range(1, n + 1)]
        wins = [ref.AckWindow(), port.AckWindow()]
        pending, acked, delivered = [], set(), 0
        commits = [0, 0]
        while delivered < n or pending:
            if delivered < n and (not pending or rng.random() < 0.5):
                lsn, size = batches[delivered]
                for w in wins:
                    w.note_batch(lsn, size)
                pending.extend((lsn, i) for i in range(size))
                rng.shuffle(pending)
                delivered += 1
                continue
            lsn, i = pending.pop()
            acked.add((lsn, i))
            got = []
            for k, (w, m) in enumerate(zip(wins, (ref, port))):
                w.ack(m.RecId(lsn, i))
                c = w.advance()
                if c is not None:
                    commits[k] = c
                got.append(commits[k])
            want = 0
            for b, size in batches[:delivered]:
                if all((b, j) in acked for j in range(size)):
                    want = b
                else:
                    break
            assert got == [want, want], (trial, got, want)
        assert commits == [n, n] and wins[1].ranges == []


# ---- the read plane -----------------------------------------------------------

def _canon(rows) -> str:
    return json.dumps(list(rows), sort_keys=True, default=float)


class _FakeEx:
    def __init__(self, live_rows=None, live_lo=None):
        self.live_rows = list(live_rows or [])
        self.live_lo = live_lo
        self.peeks = 0
        self.ver = 0

    def peek(self):
        self.peeks += 1
        return list(self.live_rows)

    def read_version(self):
        return ("fake", id(self), self.ver)

    def live_min_win_end(self):
        return self.live_lo


def _view(p, ex, closed_rows=()):
    mat = p.views.Materialization(group_cols=["k"])
    mat.task = SimpleNamespace(state_lock=p.locktrace.rlock("tasks.state"),
                               executor=ex)
    if closed_rows:
        mat.add_closed(list(closed_rows))
    return mat


def _pull(p, sql):
    return p.codegen.stream_codegen(sql).select


def _win(k, c, start=BASE):
    return {"k": k, "c": c, "winStart": start, "winEnd": start + 10_000}


def test_cache_hit_is_byte_identical_and_close_invalidates(p):
    ex = _FakeEx(live_rows=[_win("a", 2)])
    mat = _view(p, ex, [_win("a", 5, BASE - 10_000)])
    sel = _pull(p, "SELECT * FROM v;")
    cache = p.readcache.ReadCache()
    r1, how1, x1 = cache.serve_view("v", mat, sel, "q1")
    assert (how1, x1, ex.peeks) == ("miss", True, 1)
    r2, how2, x2 = cache.serve_view("v", mat, sel, "q1")
    assert (how2, x2, ex.peeks) == ("hit", False, 1)
    assert _canon(r1) == _canon(r2) == _canon(
        p.views.serve_select_view(mat, sel))
    mat.add_closed([_win("a", 7)])
    ex.live_rows, ex.ver = [], ex.ver + 1
    r3, how3, _ = cache.serve_view("v", mat, sel, "q1")
    assert how3 == "miss" and any(r["c"] == 7 for r in r3)
    ex.live_rows, ex.ver = [_win("a", 1, BASE + 10_000)], ex.ver + 1
    r4, how4, _ = cache.serve_view("v", mat, sel, "q1")
    assert how4 == "miss"
    assert _canon(r4) == _canon(p.views.serve_select_view(mat, sel))
    assert cache.hit_ratio() == pytest.approx(1 / 4)


def test_cache_statements_versions_and_budget(p):
    """Distinct statements cache apart; an executor with no read_version
    bypasses the cache; the byte budget evicts; dropping a view frees
    its entries."""
    mat = _view(p, _FakeEx(), [_win("a", 5), _win("b", 9)])
    cache = p.readcache.ReadCache()
    all_sel = _pull(p, "SELECT * FROM v;")
    one_sel = _pull(p, "SELECT * FROM v WHERE k = 'a';")
    rows_all, _, _ = cache.serve_view("v", mat, all_sel, "all")
    rows_one, how, _ = cache.serve_view("v", mat, one_sel, "one")
    assert how == "miss" and len(rows_all) == 2 and len(rows_one) == 1

    class _Bare:
        def peek(self):
            return []

    bare = _view(p, _Bare(), [_win("a", 1)])
    hows = [cache.serve_view("b", bare, all_sel, "q")[1] for _ in range(2)]
    assert hows == ["bypass", "bypass"]
    cache.invalidate_view("v")  # one invalidation per cached statement
    assert cache.stats()["invalidations"] == 2
    assert all(k[1] != "v" for k in cache._entries if k[0] == "snap")

    big = _view(p, _FakeEx(), [_win(f"k{i}", i) for i in range(50)])
    small = p.readcache.ReadCache(max_bytes=4096)
    for i in range(30):
        sql = f"SELECT * FROM v WHERE c = {i};"
        small.serve_view("v", big, _pull(p, sql), sql)
    assert small.nbytes() <= 4096 and small.stats()["evictions"] > 0


def test_staleness_bound_expires_hits(p):
    now = [100.0]
    mat = _view(p, _FakeEx(), [_win("a", 1)])
    sel = _pull(p, "SELECT * FROM v;")
    cache = p.readcache.ReadCache(max_staleness_ms=250.0,
                                  clock=lambda: now[0])
    hows = []
    for step in (0.0, 0.2, 0.2, 0.0):
        now[0] += step
        hows.append(cache.serve_view("v", mat, sel, "q")[1])
    assert hows == ["miss", "hit", "miss", "hit"]


def test_closed_only_where_skips_live_peek(p):
    closed = [_win("a", 5, BASE - 10_000)]
    ex = _FakeEx(live_rows=[_win("a", 1)], live_lo=BASE + 10_000)
    mat = _view(p, ex, closed)
    rows = p.views.serve_select_view(
        mat, _pull(p, f"SELECT * FROM v WHERE winEnd <= {BASE};"))
    assert ex.peeks == 0 and [r["c"] for r in rows] == [5]
    rows2 = p.views.serve_select_view(
        mat, _pull(p, f"SELECT * FROM v WHERE winEnd <= {BASE + 10_000};"))
    assert ex.peeks == 1 and any(r["winStart"] == BASE for r in rows2)
    p.views.serve_select_view(mat, _pull(p, "SELECT * FROM v WHERE c > 0;"))
    assert ex.peeks == 2


def test_closed_only_skips_a_real_executors_peek():
    """Against real executors (the port's on the CPU): a closed-bounded
    pull never extracts the arena; the unbounded pull's rows (closed
    plus the live peek) agree across the packages."""
    out = []
    for root in PACKAGES:
        p = _package(root)
        e = p.engine
        schema = e.Schema.of(k=e.ColumnType.STRING, v=e.ColumnType.FLOAT)
        node = e.AggregateNode(
            child=e.SourceNode(stream="s", schema=schema),
            group_keys=[p.expr.Col("k")],
            window=e.TumblingWindow(10_000, grace_ms=0),
            aggs=[e.AggSpec(e.AggKind.COUNT_ALL, "c"),
                  e.AggSpec(e.AggKind.SUM, "s", input=p.expr.Col("v"))],
            having=None, post_projections=[])
        ex = e.QueryExecutor(node, schema, emit_changes=False,
                             initial_keys=8, batch_capacity=64, **p.cpu)
        ex.process([{"k": "a", "v": 1.5}, {"k": "b", "v": 2.25},
                    {"k": "a", "v": 0.5}], [BASE, BASE + 1000, BASE + 2000])
        assert ex.live_min_win_end() == BASE + 10_000
        mat = _view(p, ex, [{"k": "z", "c": 1, "s": 0.0,
                             "winStart": BASE - 10_000, "winEnd": BASE}])
        peeks = []
        orig = ex.peek
        ex.peek = lambda: (peeks.append(1), orig())[1]
        rows = p.views.serve_select_view(
            mat, _pull(p, f"SELECT * FROM v WHERE winEnd < {BASE + 1};"))
        assert peeks == [] and [r["k"] for r in rows] == ["z"]
        out.append(p.views.serve_select_view(mat,
                                             _pull(p, "SELECT * FROM v;")))
        assert len(peeks) == 1
    assert _canon(sorted(out[0], key=repr)) == \
        _canon(sorted(out[1], key=repr))


def test_where_projection_columnwise_matches_row_path(p):
    emit = p.columnar.ColumnarEmit(
        {"k": np.array(["a", "b", "c", "d"], object),
         "c": np.array([1, 2, 3, 4], np.int64),
         "t": np.array([1.5, 2.5, 3.5, 4.5]),
         "winStart": np.full(4, BASE, np.int64),
         "winEnd": np.full(4, BASE + 10_000, np.int64)}, 4)
    for sql in ("SELECT * FROM v WHERE c > 1;",
                "SELECT k, c FROM v WHERE c >= 2 AND t < 4.0;",
                "SELECT k AS g, t FROM v;",
                "SELECT * FROM v WHERE k = 'b';",
                "SELECT k FROM v WHERE c > 100;"):
        sel = _pull(p, sql)
        want = p.views.project_rows(p.views.filter_rows(list(emit), sel),
                                    sel, keep_meta=("winStart", "winEnd"))
        assert _canon(p.views._select_emit(emit, sel)) == _canon(want), sql


def test_columnwise_failure_falls_back_to_exact_rows(p, monkeypatch):
    emit = p.columnar.ColumnarEmit({"k": np.array(["a", "b"], object),
                                    "c": np.array([1, 2], np.int64)}, 2)
    sel = _pull(p, "SELECT * FROM v WHERE c > 1;")
    want = p.views._select_emit(emit, sel)

    def boom(*a, **kw):
        raise RuntimeError("vector path down")

    monkeypatch.setattr(p.views, "_select_emit_cols", boom)
    assert _canon(p.views._select_emit(emit, sel)) == _canon(want)


@pytest.mark.parametrize("cached", [True, False])
def test_fanout_serves_every_subscription(p, cached):
    """One columnar sink record, N subscriptions: every consumer gets the
    same frames (shared by reference, expanded once, with the cache),
    decoding back to the emitted rows."""
    N = 4
    ctx = p.new_context(read_cache_bytes=(64 << 20) if cached else 0)
    try:
        ctx.streams.create_stream("fanout")
        logid = ctx.streams.get_logid("fanout")
        rows = [{"k": f"g{i}", "c": i, "winStart": BASE + i}
                for i in range(16)]
        ctx.store.append(logid, p.rec.build_record(
            p.columnar.rows_to_payload(rows, BASE)).SerializeToString())
        fetched = []
        for i in range(N):
            rt = ctx.subscriptions.create(ctx, p.pb.Subscription(
                subscription_id=f"fo{i}", stream_name="fanout"))
            fetched.append(rt.fetch(timeout_ms=200, max_size=256))
        assert [len(g) for g in fetched] == [len(rows)] * N
        decoded = [p.rec.record_to_dict(p.rec.parse_record(pay))
                   for _rid, pay in fetched[0]]
        assert decoded == rows
        if cached:
            for got in fetched[1:]:
                assert all(a[1] is b[1] for a, b in zip(fetched[0], got))
            st = ctx.read_cache.stats()
            assert (st["expand_misses"], st["expand_hits"]) == (1, N - 1)
        else:
            assert ctx.read_cache is None
        assert ctx.stats.stat_ladder("read_out_records",
                                     "fanout")["total"] == len(rows) * N
    finally:
        ctx.shutdown()


def test_drop_view_invalidates_server_cache():
    pair = Pair()
    try:
        for s in pair.sides:
            s.stub.CreateStream(s.pb.Stream(stream_name="dvsrc"))
            s.sql("CREATE VIEW dview AS SELECT city, COUNT(*) AS c "
                  "FROM dvsrc GROUP BY city, TUMBLING (INTERVAL 10 SECOND) "
                  "GRACE BY INTERVAL 0 SECOND;")
            s.task("view-dview")
            assert s.sql("SELECT * FROM dview;") == []
            s.sql("DROP VIEW dview;")
            assert all(k[1] != "dview" for k in s.ctx.read_cache._entries
                       if k[0] == "snap")
    finally:
        pair.close()


def test_concurrent_readers_exact_and_cycle_free(p):
    """Readers hammer the cache while a mutator closes windows under the
    task lock: every served snapshot equals the uncached pipeline at
    some committed version, and the armed witness sees no cycle."""
    LOCKTRACE = p.locktrace.LOCKTRACE
    LOCKTRACE.disarm()
    LOCKTRACE.arm()
    try:
        ex = _FakeEx()
        mat = _view(p, ex)
        sel = _pull(p, "SELECT * FROM v;")
        cache = p.readcache.ReadCache()
        lock = threading.Lock()
        canonical = {_canon(p.views.serve_select_view(mat, sel))}
        stop, errors = threading.Event(), []

        def reader():
            while not stop.is_set():
                rows, how, _ = cache.serve_view("v", mat, sel, "q")
                with lock:
                    ok = _canon(rows) in canonical
                if not ok:
                    errors.append(how)
                    return

        threads = [threading.Thread(target=reader) for _ in range(4)]
        for t in threads:
            t.start()
        pause = threading.Event()
        for i in range(60):
            with mat.task.state_lock:
                mat.add_closed([_win(f"k{i % 7}", i, BASE + i * 10)])
                ex.ver += 1
                with lock:
                    canonical.add(_canon(p.views.serve_select_view(mat,
                                                                   sel)))
            pause.wait(0.002)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not errors and LOCKTRACE.cycles() == []
    finally:
        LOCKTRACE.disarm()


# ---- flow control through a server context ------------------------------------

def test_stalled_subscriber_bounded_by_credit_window(p):
    WINDOW, N = 8, 50
    ctx = p.new_context(credit_window=WINDOW)
    try:
        ctx.streams.create_stream("credsrc")
        logid = ctx.streams.get_logid("credsrc")
        for i in range(N):
            ctx.store.append(logid,
                             p.rec.build_record({"i": i}).SerializeToString())
        rt = ctx.subscriptions.create(ctx, p.pb.Subscription(
            subscription_id="credsub", stream_name="credsrc"))
        consumer = rt.register_consumer("slow")

        def queued():
            with consumer.queue.mutex:
                return sum(len(b) for b in consumer.queue.queue)

        poll(queued, lambda n: n == WINDOW, 10, "credit window filled")
        assert not threading.Event().wait(0.3) and queued() == WINDOW
        assert ctx.stats.stream_stat_get("delivery_credit_waits",
                                         "credsrc") > 0
        seen = []
        while len(seen) < N:
            poll(lambda: not consumer.queue.empty(), bool, 10,
                 f"stalled after {len(seen)} records")
            batch = consumer.queue.get_nowait()
            seen.extend(p.rec.record_to_dict(p.rec.parse_record(pay))["i"]
                        for _rid, pay in batch)
            rt.ack([rid for rid, _ in batch], consumer=consumer)
        assert seen == list(range(N)) and rt.committed_lsn > 0
    finally:
        ctx.shutdown()


def test_latest_subscriber_reports_zero_backlog(p):
    ctx = p.new_context()
    try:
        ctx.streams.create_stream("longlog")
        logid = ctx.streams.get_logid("longlog")
        for i in range(20):
            ctx.store.append(logid,
                             p.rec.build_record({"i": i}).SerializeToString())
        rt = ctx.subscriptions.create(ctx, p.pb.Subscription(
            subscription_id="latest1", stream_name="longlog",
            offset=p.pb.SubscriptionOffset(special_offset=1)))
        rt.reader()
        assert rt.committed_lsn >= ctx.store.tail_lsn(logid)
    finally:
        ctx.shutdown()


def test_unary_acks_refill_streaming_consumer_credits(p):
    WINDOW = 8
    N = 3 * WINDOW
    ctx = p.new_context(credit_window=WINDOW)
    try:
        ctx.streams.create_stream("uack")
        logid = ctx.streams.get_logid("uack")
        for i in range(N):
            ctx.store.append(logid,
                             p.rec.build_record({"i": i}).SerializeToString())
        rt = ctx.subscriptions.create(ctx, p.pb.Subscription(
            subscription_id="uacksub", stream_name="uack"))
        consumer = rt.register_consumer("mixed")
        seen = 0
        while seen < N:
            poll(lambda: not consumer.queue.empty(), bool, 10,
                 f"stalled after {seen} records")
            batch = consumer.queue.get_nowait()
            seen += len(batch)
            rt.ack([rid for rid, _ in batch])
        assert seen == N
    finally:
        ctx.shutdown()


def test_quota_persists_across_server_restart(p, tmp_path):
    Quota = p.flow.Quota
    uri = str(tmp_path / "store")
    ctx = p.new_context(uri)
    ctx.flow.set_quota("stream/s", Quota(records_per_s=5, burst_records=5))
    ctx.flow.set_quota("tenant/acme", Quota(bytes_per_s=1000))
    ctx.shutdown()
    ctx2 = p.new_context(uri)
    try:
        assert ctx2.flow.get_quota("stream/s").records_per_s == 5.0
        assert ctx2.flow.get_quota("tenant/acme").bytes_per_s == 1000.0
        assert ctx2.flow.active
        ctx2.flow.admit_append("s", 5, 0)
        with pytest.raises(p.errors.ResourceExhausted):
            ctx2.flow.admit_append("s", 1, 0)
        ctx2.flow.unset_quota("tenant/acme")
    finally:
        ctx2.shutdown()
    ctx3 = p.new_context(uri)
    try:
        assert ctx3.flow.get_quota("tenant/acme") is None
        assert ctx3.flow.get_quota("stream/s") is not None
    finally:
        ctx3.shutdown()
