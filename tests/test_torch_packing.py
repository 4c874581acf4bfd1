"""Co-compile query packing (hstream_tpu_torch/placer/packing.py) against
the reference's (tests/test_packing.py).

Every case of tests/test_packing.py runs once against each package
(`p`, parametrised over torch_server.PACKAGES); the port's contexts,
executors and servers run on the CPU. "The 2nd..Nth member compiles
nothing" is each package's own RetraceGuard: XLA compiles in the
reference, the library build and program-factory misses in the port.
Then both packages are held to each other on the same inputs:
signatures, their text and every refusal's code and detail exact, and a
manual pool's demuxed rows fed the same seeded batches (keys, window
bounds, counts and HLL estimates exact, SUM within rel 1e-6,
torch_parity's bound). A pool on a CPU context packs on the CPU: the
group's executor honours the server's device.
"""

from __future__ import annotations

import importlib
import json
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from torch_parity import assert_rows_equal
from torch_server import PACKAGES

BASE = 1_700_000_000_000

CSAS = ("CREATE STREAM {sink} AS SELECT k, COUNT(*) AS {c} FROM src "
        "GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
        "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")

_MODS = {
    "packing": "placer.packing", "tracing": "common.tracing",
    "pb": "proto.api_pb2", "rpc": "proto.rpc", "context": "server.context",
    "main": "server.main", "codegen": "sql.codegen", "store": "store",
    "rec": "common.records", "columnar": "common.columnar",
    "api": "store.api",
}


def _package(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in _MODS.items()})
    ns.cpu = {"device": "cpu"} if root.endswith("_torch") else {}
    return ns


@pytest.fixture(params=PACKAGES)
def p(request):
    return _package(request.param)


def _plan(p, sql):
    return p.codegen.stream_codegen(sql)


# ---- signatures + typed refusals --------------------------------------------


def test_compatible_queries_share_a_signature(p):
    sig, refusal = p.packing.pack_signature, p.packing.PackRefusal
    s1 = sig(_plan(p, CSAS.format(sink="s1", c="c1")))
    s2 = sig(_plan(p, CSAS.format(sink="s2", c="c2")))
    assert not isinstance(s1, refusal)
    # aliases differ, the signature does not: renames are member-local
    assert s1 == s2
    assert "tumbling" in p.packing.signature_text(s1)
    # a different window shape is a different pack
    s3 = sig(_plan(p, "CREATE STREAM s3 AS SELECT k, COUNT(*) AS c FROM src "
                      "GROUP BY k, TUMBLING (INTERVAL 20 SECOND) "
                      "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;"))
    assert s3 != s1
    # ... and so is a different agg set or source stream
    s4 = sig(_plan(p, "CREATE STREAM s4 AS SELECT k, SUM(x) AS s FROM src "
                      "GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
                      "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;"))
    assert s4 != s1


REFUSALS = {
    "join": ("SELECT s1.x, s2.y FROM s1 INNER JOIN s2 "
             "WITHIN (INTERVAL 10 SECOND) ON s1.k = s2.k "
             "EMIT CHANGES;"),
    "stateless": "SELECT k FROM s EMIT CHANGES;",
    "filter": ("SELECT COUNT(*) FROM s WHERE x > 0 GROUP BY k, "
               "TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;"),
    "unwindowed": "SELECT COUNT(*) FROM s GROUP BY k EMIT CHANGES;",
    "session-window": ("SELECT COUNT(*) FROM s GROUP BY k, "
                       "SESSION (INTERVAL 30 SECOND) EMIT CHANGES;"),
    "having": ("SELECT k, COUNT(*) AS c FROM s GROUP BY k, "
               "TUMBLING (INTERVAL 10 SECOND) "
               "HAVING COUNT(*) >= 2 EMIT CHANGES;"),
    "projection": ("SELECT k, COUNT(*) + 1 AS c FROM s GROUP BY k, "
                   "TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;"),
    "computed-agg-input": ("SELECT k, SUM(x + 1) AS s FROM s "
                           "GROUP BY k, TUMBLING (INTERVAL 10 "
                           "SECOND) EMIT CHANGES;"),
}


def test_typed_refusals(p):
    for code, sql in REFUSALS.items():
        out = p.packing.pack_signature(_plan(p, sql))
        assert isinstance(out, p.packing.PackRefusal), (code, out)
        assert out.code == code, (code, out)


def test_explain_surfaces_pack_verdict(p):
    packable = p.codegen.explain_text(_plan(p, CSAS.format(sink="s1",
                                                           c="c1")))
    assert "PACK: packable with --pack-queries" in packable
    refused = p.codegen.explain_text(_plan(
        p, "SELECT COUNT(*) FROM s GROUP BY k, "
           "SESSION (INTERVAL 30 SECOND) EMIT CHANGES;"))
    assert "PACK: unpackable — session-window:" in refused


PACKABLE = [
    CSAS.format(sink="s1", c="c1"),
    "SELECT k, j, SUM(x) AS s, MIN(x), MAX(x) FROM src GROUP BY k, j, "
    "HOPPING (INTERVAL 60 SECOND, INTERVAL 10 SECOND) EMIT CHANGES;",
    "SELECT k AS kk, APPROX_QUANTILE(x, 0.9) AS q, TOPK(x, 3) AS t "
    "FROM src GROUP BY k, TUMBLING (INTERVAL 5 SECOND);",
    "SELECT COUNT(*), AVG(x), COUNT(x), APPROX_COUNT_DISTINCT(x) FROM src "
    "GROUP BY k, TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 2 "
    "SECOND EMIT CHANGES;",
]


@pytest.mark.parametrize("sql", PACKABLE + list(REFUSALS.values()),
                         ids=lambda s: s[:40])
def test_signatures_and_refusals_match_across_packages(sql):
    """The same SQL through both packages: the signature tuple and its
    text, or the refusal's code and detail, equal."""
    j, t = (_package(root) for root in PACKAGES)
    sj = j.packing.pack_signature(_plan(j, sql))
    st = t.packing.pack_signature(_plan(t, sql))
    if isinstance(sj, j.packing.PackRefusal):
        assert isinstance(st, t.packing.PackRefusal), st
        assert (st.code, st.detail, str(st)) == (sj.code, sj.detail, str(sj))
    else:
        assert st == sj
        assert t.packing.signature_text(st) == j.packing.signature_text(sj)


# ---- manual pack groups: zero recompiles + exact demux ----------------------


def _manual_pool(p):
    store = p.store.open_store("mem://")
    ctx = p.context.ServerContext(store, owns_store=False, **p.cpu)
    ctx.streams.create_stream("src")
    return store, ctx, p.packing.PackPool(ctx, manual=True)


def test_attach_never_lands_on_a_torn_down_group(p):
    """try_attach holds the pool lock across lookup+attach, so a
    concurrent detach of the group's last member can never pop the group
    between the two: right after attach, the member's group IS the
    pool's registered group for its signature."""
    store, ctx, pool = _manual_pool(p)
    try:
        plan_churn = _plan(p, CSAS.format(sink="sc", c="c"))
        plan_main = _plan(p, CSAS.format(sink="sq", c="c"))
        sink = lambda rows: None  # noqa: E731
        stop = threading.Event()

        def churn():
            i = 0
            while not stop.is_set():
                pool.try_attach(f"churn-{i}", plan_churn, sink)
                pool.detach(f"churn-{i}")
                i += 1

        t = threading.Thread(target=churn, daemon=True)
        t.start()
        try:
            for i in range(300):
                task = pool.try_attach(f"q-{i}", plan_main, sink)
                assert isinstance(task, p.packing.PackMemberTask)
                assert pool.member_of(f"q-{i}") is task.group
                assert pool.groups.get(task.group.sig) is task.group
                assert f"q-{i}" in task.group.members
                pool.detach(f"q-{i}")
        finally:
            stop.set()
            t.join(timeout=10)
        assert not t.is_alive()
    finally:
        ctx.shutdown()
        store.close()


def test_second_and_third_member_compile_nothing(p):
    """Once the group's lattice is warm, attaching the 2nd..Nth
    compatible query and streaming through it compiles nothing: the
    tagged width stays in one pow2 bucket and the key-id span was warmed
    past 32 ids (tests/test_packing.py's discipline)."""
    RetraceGuard = p.tracing.RetraceGuard
    store, ctx, pool = _manual_pool(p)
    try:
        out1, out2, out3 = [], [], []
        t1 = pool.try_attach("q1", _plan(p, CSAS.format(sink="s1", c="c1")),
                             out1.extend)
        assert isinstance(t1, p.packing.PackMemberTask)
        g = pool.member_of("q1")
        for w in range(11):
            ks = ["k0"] + [f"k{3 * w + i}" for i in (1, 2, 3)]
            g.feed([{"k": k} for k in ks], BASE + w * 10_000, lsn=10 + w)
        assert out1, "warm windows must have closed and emitted"

        t2 = pool.try_attach("q2", _plan(p, CSAS.format(sink="s2", c="c2")),
                             out2.extend)
        assert isinstance(t2, p.packing.PackMemberTask)
        with RetraceGuard() as guard:
            for w in range(11, 15):
                g.feed([{"k": "k1"}, {"k": "k2"}],
                       BASE + w * 10_000, lsn=100 + w)
        assert guard.count == 0, f"2nd member recompiled {guard.count}x"
        assert out2, "2nd member demuxed no rows"

        pool.try_attach("q3", _plan(p, CSAS.format(sink="s3", c="c3")),
                        out3.extend)
        with RetraceGuard() as guard:
            for w in range(15, 19):
                g.feed([{"k": "k1"}], BASE + w * 10_000, lsn=200 + w)
        assert guard.count == 0, f"3rd member recompiled {guard.count}x"
        assert out3, "3rd member demuxed no rows"

        st = g.status()
        assert st["members"] == ["q1", "q2", "q3"]
        assert st["compiled"] and st["batches"] >= 19
        assert pool.member_of("q2") is g and pool.member_of("q3") is g
    finally:
        ctx.shutdown()
        store.close()


def test_demux_exact_vs_standalone_executors(p):
    """Each member's packed output equals a standalone executor fed the
    identical row/ts sequence, its own SELECT-list renames included."""
    store, ctx, pool = _manual_pool(p)
    try:
        p1 = _plan(p, CSAS.format(sink="s1", c="c1"))
        p2 = _plan(p, CSAS.format(sink="s2", c="c2"))
        out1, out2 = [], []
        pool.try_attach("q1", p1, out1.extend)
        pool.try_attach("q2", p2, out2.extend)
        g = pool.member_of("q1")

        batches = []
        for w in range(6):
            rows = [{"k": k} for k in ("a", "b", "a", "c")]
            batches.append((rows, [BASE + w * 10_000 + i
                                   for i in range(4)]))
        for i, (rows, ts) in enumerate(batches):
            g.feed(rows, ts, lsn=10 + i)

        def reference(plan):
            ex = p.codegen.make_executor(plan.select,
                                         sample_rows=[{"k": "a"}], **p.cpu)
            out = []
            for rows, ts in batches:
                out.extend(ex.process(rows, ts))
            return out

        key = lambda r: (r.get("winStart"), sorted(r.items()))  # noqa: E731
        ref1 = reference(p1)
        assert ref1, "reference emitted nothing; test is vacuous"
        assert sorted(out1, key=key) == sorted(ref1, key=key)
        ref2 = reference(p2)
        assert sorted(out2, key=key) == sorted(ref2, key=key)
        assert {"c1"} == {k for r in out1 for k in r} - \
            {"k", "winStart", "winEnd"}
        assert {"c2"} == {k for r in out2 for k in r} - \
            {"k", "winStart", "winEnd"}
    finally:
        ctx.shutdown()
        store.close()


def test_attach_lsn_gates_late_members_and_detach_tears_down(p):
    store, ctx, pool = _manual_pool(p)
    try:
        out1, out2 = [], []
        pool.try_attach("q1", _plan(p, CSAS.format(sink="s1", c="c1")),
                        out1.extend)
        g = pool.member_of("q1")
        m1_lsn = g.members["q1"].attach_lsn
        g.feed([{"k": "a"}], BASE, lsn=m1_lsn + 1)
        pool.try_attach("q2", _plan(p, CSAS.format(sink="s2", c="c2")),
                        out2.extend)
        g.members["q2"].attach_lsn = m1_lsn + 5  # attach point
        g.feed([{"k": "a"}], BASE + 1, lsn=m1_lsn + 2)   # pre-attach
        g.feed([{"k": "a"}], BASE + 2, lsn=m1_lsn + 6)   # post-attach
        g.feed([{"k": "z"}], BASE + 30_000, lsn=m1_lsn + 7)  # closer
        c1 = max(r["c1"] for r in out1 if r["k"] == "a")
        c2 = max(r["c2"] for r in out2 if r["k"] == "a")
        assert c1 == 3      # saw all three rows
        assert c2 == 1      # only the post-attach row
        pool.detach("q1")
        assert pool.member_of("q1") is None
        assert g.status()["members"] == ["q2"]
        pool.detach("q2")
        assert pool.groups == {} and pool.member_of("q2") is None
    finally:
        ctx.shutdown()
        store.close()


# ---- both packages on the same batches --------------------------------------


PACK3 = ("CREATE STREAM {sink} AS SELECT k, COUNT(*) AS c{i}, SUM(x) AS "
         "s{i}, APPROX_COUNT_DISTINCT(x) AS d{i} FROM src GROUP BY k, "
         "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND "
         "EMIT CHANGES;")


def _seeded_batches(seed: int = 21):
    rng = np.random.default_rng(seed)
    batches = []
    for w in range(6):
        for half in range(2):
            n = int(rng.integers(80, 160))
            keys = rng.integers(0, 24, n)
            xs = np.rint(rng.normal(20.0, 5.0, n) * 10) / 10
            ts = (BASE + w * 10_000 + half * 5_000
                  + np.sort(rng.integers(0, 5_000, n)))
            batches.append(([{"k": f"k{k}", "x": float(x)}
                             for k, x in zip(keys, xs)], ts.tolist()))
    batches.append(([{"k": "zz", "x": 0.0}], [BASE + 90_000]))
    return batches


def test_packed_rows_match_across_packages():
    """Three members (the third attached after four batches) fed the
    same seeded batches in both packages: each member's demuxed rows
    equal, keys, window bounds, counts and HLL estimates exact and SUM
    within rel 1e-6."""
    batches = _seeded_batches()
    got = {}
    for root in PACKAGES:
        p = _package(root)
        store, ctx, pool = _manual_pool(p)
        try:
            sinks = [[], [], []]
            for i in range(3):
                pool.try_attach(f"q{i}", _plan(p, PACK3.format(
                    sink=f"s{i}", i=i)), sinks[i].extend)
            g = pool.member_of("q0")
            g.members["q2"].attach_lsn = 13
            for j, (rows, ts) in enumerate(batches):
                g.feed(rows, ts, lsn=10 + j)
            got[root] = sinks
        finally:
            ctx.shutdown()
            store.close()
    ref, port = (got[root] for root in PACKAGES)
    for i in range(3):
        order = lambda rows: sorted(  # noqa: E731
            rows, key=lambda r: (r["winStart"], r["k"], r[f"c{i}"]))
        want, have = order(ref[i]), order(port[i])
        assert want, f"member {i} emitted nothing"
        assert_rows_equal(want, have)
        assert [r[f"d{i}"] for r in have] == [r[f"d{i}"] for r in want]
    assert len(ref[2]) < len(ref[0])  # the late member saw less


def test_a_cpu_context_packs_on_the_cpu():
    """The pack group's executor lives on the server's device: a pool on
    a CPU context feeds a packed batch without raising (with no card,
    an executor left to resolve its own device raises), its planes on
    the CPU, its rows the reference group's."""
    rows = [{"k": k, "x": float(i)} for i, k in enumerate("abacab")]
    ts = [BASE + i for i in range(6)]
    got = {}
    for root in PACKAGES:
        p = _package(root)
        store, ctx, pool = _manual_pool(p)
        try:
            out = []
            pool.try_attach("q1", _plan(p, PACK3.format(sink="s1", i=1)),
                            out.extend)
            g = pool.member_of("q1")
            g.feed(rows, ts, lsn=10)
            g.feed([{"k": "z", "x": 0.0}], BASE + 30_000, lsn=11)
            if p.cpu:
                assert g.executor.device.type == "cpu"
                assert all(t.device.type == "cpu"
                           for t in g.executor.state.values())
            got[root] = sorted(out, key=lambda r: (r["winStart"], r["k"],
                                                   r["c1"]))
        finally:
            ctx.shutdown()
            store.close()
    assert got["hstream_tpu"]
    assert_rows_equal(got["hstream_tpu"], got["hstream_tpu_torch"])


# ---- server-level packing: --pack-queries end to end ------------------------


def _wait(cond, timeout=20.0, step=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


def _read_sink(p, ctx, stream):
    logid = ctx.streams.get_logid(stream)
    tail = ctx.store.tail_lsn(logid)
    out = []
    if not tail:
        return out
    r = ctx.store.new_reader()
    r.set_timeout(0)
    r.start_reading(logid, 1, tail)
    while True:
        items = r.read(256)
        if not items:
            break
        for it in items:
            if not isinstance(it, p.api.DataBatch):
                continue
            for payload in it.payloads:
                pr = p.rec.parse_record(payload)
                crows = p.columnar.payload_rows(pr.payload)
                if crows is not None:
                    out.extend(crows)
                    continue
                row = p.rec.record_to_dict(pr)
                if row is not None:
                    out.append(row)
    return out


def test_server_packs_compatible_queries_one_group(p):
    pb, rec = p.pb, p.rec
    server, ctx = p.main.serve("127.0.0.1", 0, "mem://", pack_queries=True,
                               **p.cpu)
    ch = None
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
        stub = p.rpc.HStreamApiStub(ch)
        stub.CreateStream(pb.Stream(stream_name="src"))
        stub.ExecuteQuery(pb.CommandQuery(
            stmt_text=CSAS.format(sink="snk1", c="c1")))
        stub.ExecuteQuery(pb.CommandQuery(
            stmt_text=CSAS.format(sink="snk2", c="c2")))
        tasks = list(ctx.running_queries.values())
        assert len(tasks) == 2
        assert all(getattr(t, "packed", False) for t in tasks)
        packs = ctx.pack_pool.status()
        assert len(packs) == 1 and len(packs[0]["members"]) == 2
        resp = stub.SendAdminCommand(pb.AdminCommandRequest(
            command="placer", args=rec.dict_to_struct({})))
        assert len(json.loads(resp.result)["packs"]) == 1

        req = pb.AppendRequest(stream_name="src")
        for i, t in enumerate([BASE, BASE + 1, BASE + 2]):
            req.records.append(rec.build_record({"k": "a", "i": i},
                                                publish_time_ms=t))
        stub.Append(req)
        closer = pb.AppendRequest(stream_name="src")
        closer.records.append(rec.build_record(
            {"k": "zz"}, publish_time_ms=BASE + 30_000))
        stub.Append(closer)

        def emitted(stream, col):
            return [r for r in _read_sink(p, ctx, stream)
                    if r.get("k") == "a" and r.get(col) == 3]

        assert _wait(lambda: emitted("snk1", "c1") and
                     emitted("snk2", "c2"), timeout=30), \
            (_read_sink(p, ctx, "snk1"), _read_sink(p, ctx, "snk2"))
        if p.cpu:
            group = ctx.pack_pool.member_of(sorted(ctx.running_queries)[0])
            assert group.executor.device.type == "cpu"
        qids = sorted(ctx.running_queries)
        stub.TerminateQueries(pb.TerminateQueriesRequest(
            query_ids=[qids[0]]))
        assert _wait(lambda: len(ctx.pack_pool.status()) == 1 and
                     len(ctx.pack_pool.status()[0]["members"]) == 1)
    finally:
        if ch is not None:
            ch.close()
        server.stop(grace=0.5)
        ctx.shutdown()
