"""The port's device cost plane on its server, against the reference's
where the two mean the same (tests/test_devicecost.py): the
compiled-program inventory under the port's own compile names (the
kernel library's build, `lattice.compiled`, `expr.lower`,
`expr.launch_plan`), `query_hbm_bytes` and the `/metrics` device
families against a brute-force recompute, the HBM backend gauge's
absence on the CPU, and the flight recorder's bundles."""

import json
import urllib.request

import numpy as np
import pytest

from torch_server import BASE, Pair, poll

from hstream_tpu_torch.common.tracing import RetraceGuard, kernel_family
from hstream_tpu_torch.stats.devicecost import (
    PROGRAMS,
    ProgramInventory,
    backend_hbm_bytes,
    query_hbm_bytes,
    shape_key,
)


def _brute_bytes(planes) -> dict[str, int]:
    """Per-plane bytes from shape and dtype, not from `nbytes`."""
    out = {}
    for name, arr in dict(planes).items():
        nb = int(np.prod(arr.shape)) * arr.element_size()
        if nb:
            out[str(name)] = nb
    return out


@pytest.fixture(scope="module")
def pair():
    p = Pair(metrics_port=0)
    yield p
    p.close()


def _admin(s, command, **kw):
    resp = s.stub.SendAdminCommand(s.pb.AdminCommandRequest(
        command=command, args=s.rec.dict_to_struct(kw)))
    return json.loads(resp.result)


def _metric(text, prefix):
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def test_program_inventory_one_row_per_shape_key():
    """A factory miss is one compile and one row under the dispatching
    family; a hit is neither; another program is another row."""
    from hstream_tpu_torch.engine import expr as texpr
    from hstream_tpu_torch.engine.types import ColumnType, Schema

    assert PROGRAMS.install()
    schema = Schema.of(v=ColumnType.FLOAT)
    keys0 = {r["shape_key"] for r in PROGRAMS.rows()}
    with RetraceGuard() as g:
        with kernel_family("step"):
            # compile_device lowers the program to check its slots
            prog = texpr.compile_device(
                texpr.BinOp("*", texpr.Col("v"), texpr.Lit(0.8125)), schema)
    assert g.count == 1
    new = [r for r in PROGRAMS.rows() if r["shape_key"] not in keys0]
    assert len(new) == 1
    row = new[0]
    assert (row["name"], row["family"], row["compiles"]) == \
        ("expr.lower", "step", 1)
    assert row["compile_ms"] >= 0 and row["flops"] is None
    assert row["shape_key"] == shape_key((prog,), {})
    keys1 = keys0 | {row["shape_key"]}
    with RetraceGuard() as g2:
        texpr.lower(prog)
    assert g2.count == 0 and {r["shape_key"] for r in PROGRAMS.rows()} == \
        keys1
    other = texpr.compile_device(
        texpr.BinOp("*", texpr.Col("v"), texpr.Lit(0.40625)), schema)
    with RetraceGuard() as g3:
        texpr.launch_plan(((other, "o"),))
    assert g3.count >= 1
    names = {r["name"] for r in PROGRAMS.rows()
             if r["shape_key"] not in keys1}
    assert "expr.launch_plan" in names
    s = PROGRAMS.summary()
    assert s["installed"] and s["programs"] >= 2 and s["total_compiles"] >= 2


def test_program_inventory_lru_bound_folds_into_evicted():
    inv = ProgramInventory()
    inv.MAX_ROWS = 4
    inv.record("expr.lower", "k0", 1.0)  # before install: nothing kept
    assert inv.rows() == [] and not inv.summary()["installed"]
    inv.install()
    for i in range(6):
        inv.record("expr.lower", f"k{i}", 1.0)
    inv.record("expr.lower", "k5", 2.0)  # the same key again: one row
    assert len(inv.rows()) == 4 and inv.evicted == 2
    assert inv.rows()[-1]["compiles"] == 2
    assert inv.rows()[-1]["compile_ms"] == 3.0
    assert all(r["bytes_accessed"] is None for r in inv.rows())


def test_the_kernel_library_build_is_a_row(monkeypatch, tmp_path):
    from hstream_tpu_torch.engine.kernels import build as build_mod

    PROGRAMS.install()
    monkeypatch.setattr(build_mod, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build_mod, "_noted", False)
    digest = build_mod._digest()
    (tmp_path / f"libhs_kernels_{digest}.so").write_bytes(b"")
    build_mod.build()
    build_mod.build()
    rows = [r for r in PROGRAMS.rows()
            if r["shape_key"] == f"hs_kernels:{digest}"]
    assert len(rows) == 1 and rows[0]["name"] == "kernels.build"


def test_backend_gauge_is_absent_on_the_cpu():
    assert backend_hbm_bytes("cpu") is None


def test_device_gauges_on_live_metrics_match_brute_force(pair):
    """`device_hbm_bytes{query}` on a live port server equals the
    brute-force plane recompute, per plane and in total, as the
    reference's does; query_hbm_bytes gives the same; the deleted
    query's series go."""
    from hstream_tpu_torch.stats.prometheus import render_metrics

    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="dgsrc"))
        q = s.stub.CreateQuery(s.pb.CreateQueryRequest(
            query_text="SELECT k, COUNT(*) AS c, SUM(v) AS t FROM dgsrc "
                       "GROUP BY k, TUMBLING (INTERVAL 1 SECOND) "
                       "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;",
            id="qdg1"))
        task = s.task(q.id)
        s.append("dgsrc", [{"k": f"k{i % 3}", "v": 0.5 * i}
                           for i in range(8)],
                 [BASE + i for i in range(8)])
        planes = poll(task.device_plane_bytes, bool, 20,
                      f"{s.m.root}: executor resident")
        return q.id, task, planes

    (_, rtask, rplanes), (qid, task, planes) = pair.each(run)
    port = pair.port
    assert planes == _brute_bytes(task.executor.state)
    assert set(planes) == set(rplanes)  # the same planes in both packages
    assert query_hbm_bytes(port.ctx, qid) == {
        "total": sum(planes.values()), "planes": dict(sorted(planes.items()))}
    text = render_metrics(port.ctx)
    line = _metric(text, f'hstream_device_hbm_bytes{{query="{qid}"')
    assert line and line[0].split()[-1] == str(sum(planes.values()))
    for plane, nb in planes.items():
        pl = [ln for ln in _metric(text, "hstream_device_arena_bytes{")
              if f'query="{qid}"' in ln and f'plane="{plane}"' in ln]
        assert pl and pl[0].split()[-1] == str(nb), plane
    tot = _metric(text, "hstream_device_hbm_total_bytes")
    assert tot and int(float(tot[0].split()[-1])) >= sum(planes.values())
    assert not _metric(text, "hstream_device_hbm_backend_bytes")
    # the same exposition over the exporter's HTTP port
    url = f"http://127.0.0.1:{port.ctx.metrics_httpd.server_port}/metrics"
    with urllib.request.urlopen(url, timeout=10) as resp:
        served = resp.read().decode()
    assert _metric(served, f'hstream_device_hbm_bytes{{query="{qid}"')
    for s in pair.sides:
        s.stub.DeleteQuery(s.pb.DeleteQueryRequest(id=qid))
    poll(lambda: qid in port.ctx.running_queries, lambda r: not r, 10,
         "query deleted")
    assert f'hstream_device_hbm_bytes{{query="{qid}"' not in \
        render_metrics(port.ctx)


def test_admin_programs_verb(pair):
    """`admin programs` on both servers: installed, one row per shape key
    with its compiles; the port's rows carry its own compile names."""
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="prsrc"))
        s.sql("CREATE VIEW prv AS SELECT k, SUM(v * 2.0 + 1.0) AS t "
              "FROM prsrc WHERE v > 0.0 GROUP BY k, "
              "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND;")
        s.task("view-prv")
        s.append("prsrc", [{"k": "a", "v": 1.0}, {"k": "b", "v": 2.0}],
                 [BASE, BASE + 1])
        poll(lambda: s.sql("SELECT * FROM prv;"), lambda rs: len(rs) == 2,
             20, f"{s.m.root}: view rows")
        return _admin(s, "programs")

    ref, port = pair.each(run)
    for got in (ref, port):
        assert got["summary"]["installed"] is True
        assert got["summary"]["programs"] == len(got["programs"])
        assert got["programs"]
        for row in got["programs"]:
            assert row["shape_key"] and row["compiles"] >= 1
            assert set(row) == set(ref["programs"][0])
    assert {r["name"] for r in port["programs"]} <= {
        "kernels.build", "lattice.compiled", "expr.lower",
        "expr.launch_plan"}


def test_flightrec_once_per_episode_and_survives_deletion(pair):
    """The breaker opening writes one bundle, the STALLED verdict one
    more and only one; the bundles outlive the query; both servers
    write the same sections."""
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="frsrc"))
        q = s.stub.CreateQuery(s.pb.CreateQueryRequest(
            query_text="SELECT k, COUNT(*) AS c FROM frsrc GROUP BY k, "
                       "TUMBLING (INTERVAL 1 SECOND) EMIT CHANGES;",
            id="qfr1"))
        task = s.task(q.id)
        task.stop(crash=True)
        poll(lambda: q.id in s.ctx.running_queries, lambda r: not r, 10,
             f"{s.m.root}: crashed task gone")
        info = s.ctx.persistence.get_query(q.id)
        sup = s.ctx.supervisor
        for _ in range(sup.BREAKER_K):
            sup.note_death(info, RuntimeError("boom"))
        assert q.id in sup.status()["breaker_open"]
        first = [b["trigger"] for b in s.ctx.flightrec.bundles(q.id)]
        verdict = _admin(s, "health", query=q.id)["verdict"]
        _admin(s, "health", query=q.id)
        bundles = _admin(s, "flightrec", query=q.id)["bundles"]
        s.stub.DeleteQuery(s.pb.DeleteQueryRequest(id=q.id))
        kept = len(s.ctx.flightrec.bundles(q.id))
        return first, verdict, bundles, kept

    ref, port = pair.each(run)
    assert port[0] == ref[0] == ["crash_loop_open"]
    assert port[1] == ref[1] == "STALLED"
    assert [b["trigger"] for b in port[2]] == \
        [b["trigger"] for b in ref[2]] == ["crash_loop_open",
                                           "query_stalled"]
    assert set(port[2][-1]) == set(ref[2][-1])
    b = port[2][-1]
    assert b["programs"]["summary"]["installed"] is True
    assert b["hbm"]["total"] == 0 and "crash_loop" in b["health"]["reasons"]
    assert port[3] == ref[3] == 2
