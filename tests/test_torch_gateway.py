"""The port's HTTP gateway and SQL shell (hstream_tpu_torch/http_gateway,
hstream_tpu_torch/client) against the reference's, each over its own
package's server (the port's on the CPU).

Every case of tests/test_client_gateway.py runs against both stacks and
their answers are compared. Fields that differ between two processes by
nature are masked, and only those, each by name (`MASKED`):
  * `id` of a query (generated ids; `deleted` names it back) and
    `created_time_ms` (the clock);
  * `port` of a node (each server listens on an ephemeral port);
  * the `rates` of a stream's overview stats and the `value` of a flow
    signal (both follow the clock);
  * a stream's `device_h2d_bytes` and `device_d2h_bytes` counters (each
    package counts its own uploads and fetches: the reference's device
    is JAX's, the port's is PyTorch's);
  * the server address the shell and the gateway follow after a leader
    hint (each stack's own).
The EXPLAIN text of the port has no PACK line (the placer's co-compile
packing, ROADMAP A9): the shell's EXPLAIN is compared without it, and
its MESH line without the count of devices (the reference's test process
sees 8 virtual JAX devices, the port one CPU device).
"""

from __future__ import annotations

import importlib
import io
import json
import re
import urllib.error
import urllib.request
from concurrent import futures
from types import SimpleNamespace

import grpc
import pytest

from torch_server import BASE, Pair, poll

MASKED = frozenset({"id", "deleted", "created_time_ms", "port", "rates",
                    "value",
                    "device_h2d_bytes", "device_d2h_bytes"})


def mask(x):
    """`x` with every MASKED field's value replaced by a marker."""
    if isinstance(x, dict):
        return {k: "<masked>" if k in MASKED else mask(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [mask(v) for v in x]
    return x


class Stack:
    """One package's server, its gateway and its modules."""

    def __init__(self, side):
        self.side = side
        root = side.m.root
        self.gw_mod = importlib.import_module(f"{root}.http_gateway")
        self.client = importlib.import_module(f"{root}.client")
        self.retry = importlib.import_module(f"{root}.client.retry")
        self.httpd, self.gw = self.gw_mod.serve_gateway(side.addr, port=0)
        self.base = f"http://127.0.0.1:{self.httpd.server_port}"

    def close(self):
        self.httpd.shutdown()
        self.gw.close()

    def http_full(self, method, path, body=None, base=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request((base or self.base) + path, data=data,
                                     method=method)
        if data:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read()), dict(
                    resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), dict(e.headers)

    def http(self, method, path, body=None):
        code, payload, _ = self.http_full(method, path, body)
        return code, payload

    def admin(self, command, **kwargs):
        s = self.side
        resp = s.stub.SendAdminCommand(s.pb.AdminCommandRequest(
            command=command, args=s.rec.dict_to_struct(kwargs)))
        return json.loads(resp.result)


@pytest.fixture(scope="module")
def stacks():
    pair = Pair()
    made = []
    try:
        for side in pair.sides:
            made.append(Stack(side))
        yield SimpleNamespace(ref=made[0], port=made[1], all=made)
    finally:
        for s in made:
            s.close()
        pair.close()


def each(stacks, fn):
    """fn(stack) on both stacks: (ref, port)."""
    return fn(stacks.ref), fn(stacks.port)


def same(stacks, fn):
    """fn(stack) on both; the masked answers must be equal. Returns the
    port's."""
    ref, port = each(stacks, fn)
    assert mask(ref) == mask(port), (ref, port)
    return port


def shell(stack, lines) -> str:
    out = io.StringIO()
    client = stack.client.Client(stack.side.addr, out=out)
    try:
        client.repl(input_lines=lines)
    finally:
        client.close()
    return out.getvalue()


# ---- the SQL shell -----------------------------------------------------------

def test_repl_scripted_session(stacks):
    """Statements routed by the shell, a multi-line INSERT, SHOW, a
    parse error the shell survives: the same text from both."""
    text = same(stacks, lambda s: shell(s, [
        "CREATE STREAM shell_s;",
        "INSERT INTO shell_s (city, temp)",
        "  VALUES ('sf', 21.5);",
        "SHOW STREAMS;",
        "SELECT nope FROM;",
        "\\q"]))
    assert "shell_s" in text and "lsn" in text and "parse error" in text


def test_repl_explain(stacks):
    """EXPLAIN through the shell: the plan's lines equal, the port's
    without the PACK line."""
    def plan_lines(s):
        text = shell(s, ["CREATE STREAM shell_x;",
                         "EXPLAIN SELECT COUNT(*) FROM shell_x GROUP BY "
                         "city EMIT CHANGES;", "\\q"])
        lines = [ln.strip(" |") for ln in text.splitlines()
                 if not ln.startswith("+")]
        return [re.sub(r"over \d+ chips", "over <n> chips", ln)
                for ln in lines if ln and not ln.startswith("PACK:")]

    ref, port = each(stacks, plan_lines)
    assert ref == port and any("AGGREGATE" in ln for ln in port)


def test_repl_ddl_routing_and_pull_query(stacks):
    def run(s):
        out = io.StringIO()
        client = s.client.Client(s.side.addr, out=out)
        try:
            client.execute("CREATE STREAM replsrc;")
            client.execute(
                "CREATE VIEW replview AS SELECT city, COUNT(*) AS c "
                "FROM replsrc GROUP BY city, TUMBLING (INTERVAL 10 SECOND) "
                "GRACE BY INTERVAL 0 SECOND;")
            s.side.task("view-replview")
            s.side.append("replsrc", [{"city": c} for c in
                                      ("sf", "sf", "la", "zz")],
                          [BASE, BASE + 1, BASE + 2, BASE + 30_000])

            def pull():
                out.truncate(0)
                out.seek(0)
                client.execute("SELECT * FROM replview WHERE city = 'sf';")
                return out.getvalue()

            text = poll(pull, lambda t: "| 2 " in t, 30.0,
                        f"{s.side.m.root}: shell pull")
            return [ln for ln in text.splitlines() if "sf" in ln]
        finally:
            client.close()

    rows = same(stacks, run)
    assert len(rows) == 1


def test_format_table_alignment(stacks):
    rows = [{"a": 1, "b": "xy"}, {"a": 200, "b": None}]
    t = same(stacks, lambda s: [s.client.format_table(rows),
                                s.client.format_table([])])
    assert "NULL" in t[0] and "(2 rows)" in t[0] and t[1] == "(0 rows)"


# ---- the HTTP gateway --------------------------------------------------------

def test_http_stream_crud_and_append(stacks):
    def run(s):
        return [s.http("POST", "/streams", {"name": "hs1"}),
                s.http("GET", "/streams"),
                s.http("POST", "/streams/hs1/append",
                       {"records": [{"a": 1, "__time_ms": BASE},
                                    {"a": 2, "__time_ms": BASE + 1}]}),
                s.http("DELETE", "/streams/hs1"),
                s.http("DELETE", "/streams/hs1")]

    out = same(stacks, run)
    assert [c for c, _ in out] == [201, 200, 200, 200, 404]


def test_http_query_lifecycle(stacks):
    def run(s):
        s.http("POST", "/streams", {"name": "hqsrc"})
        code, q = s.http("POST", "/queries",
                         {"sql": "SELECT a, COUNT(*) AS c FROM hqsrc "
                                 "GROUP BY a, TUMBLING (INTERVAL 10 SECOND) "
                                 "EMIT CHANGES;"})
        qid = q["id"]
        got = s.http("GET", f"/queries/{qid}")
        listed = [x for x in s.http("GET", "/queries")[1]
                  if x["id"] == qid]
        return [(code, q), got, len(listed), s.http("DELETE",
                                                    f"/queries/{qid}"),
                s.http("GET", f"/queries/{qid}")[0]]

    out = same(stacks, run)
    assert out[0][0] == 201 and out[2] == 1 and out[4] == 404


def test_http_views_and_overview_stats(stacks):
    def run(s):
        s.http("POST", "/streams", {"name": "hvsrc"})
        refused = s.http("POST", "/queries",
                         {"sql": "CREATE VIEW hview AS SELECT k, "
                                 "COUNT(*) AS c FROM hvsrc GROUP BY k, "
                                 "TUMBLING (INTERVAL 10 SECOND) "
                                 "GRACE BY INTERVAL 0 SECOND;"})
        s.side.sql("CREATE VIEW hview AS SELECT k, COUNT(*) AS c "
                   "FROM hvsrc GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
                   "GRACE BY INTERVAL 0 SECOND;")
        s.side.task("view-hview")
        s.http("POST", "/streams/hvsrc/append",
               {"records": [{"k": "a", "__time_ms": BASE},
                            {"k": "a", "__time_ms": BASE + 1},
                            {"k": "b", "__time_ms": BASE + 2}]})
        s.http("POST", "/streams/hvsrc/append",
               {"records": [{"k": "zz", "__time_ms": BASE + 30_000}]})
        views = s.http("GET", "/views")
        rows = poll(lambda: s.http("GET", "/views/hview")[1],
                    lambda rs: any(r.get("k") == "zz" for r in rs), 30.0,
                    f"{s.side.m.root}: /views/hview")
        code, ov = s.http("GET", "/overview")
        hv = [x for x in ov["stats"] if x["stream"] == "hvsrc"]
        return [refused, views, sorted(rows, key=lambda r: (r["winStart"],
                                                            r["k"])),
                code, ov["streams"], ov["nodes"], hv,
                s.http("DELETE", "/views/hview")]

    out = same(stacks, run)
    assert any(r["k"] == "a" and r["c"] == 2 for r in out[2])
    assert out[6][0]["counters"]["append_total"] >= 2


def test_http_connectors_and_nodes(stacks):
    def run(s):
        code, sw = s.http("GET", "/swagger.json")
        return [s.http("GET", "/nodes"), (code, sorted(sw["paths"])),
                s.http("GET", "/connectors"),
                s.http("POST", "/connectors", {})]

    out = same(stacks, run)
    assert out[0][1][0]["status"] == "Running" and out[3][0] == 400
    assert "/overview" in out[1][1]


def test_http_malformed_bodies_get_json_errors(stacks):
    def run(s):
        bad_rf = s.http("POST", "/streams",
                        {"name": "x1", "replication_factor": "two"})
        s.http("POST", "/streams", {"name": "x1"})
        return [bad_rf, s.http("POST", "/streams/x1/append",
                               {"records": ["oops"]}),
                s.http("GET", "/streams?foo=1")[0]]

    out = same(stacks, run)
    assert out[0][0] == out[1][0] == 400 and out[2] == 200


def test_getstats_excludes_deleted_streams(stacks):
    def run(s):
        s.http("POST", "/streams", {"name": "gone"})
        s.http("POST", "/streams/gone/append", {"records": [{"a": 1}]})
        s.http("DELETE", "/streams/gone")
        out = s.side.stub.GetStats(s.side.pb.GetStatsRequest())
        return [st.stream_name for st in out.stats
                if st.stream_name == "gone"]

    assert same(stacks, run) == []


def test_grpc_getstats_direct(stacks):
    def run(s):
        out = s.side.stub.GetStats(s.side.pb.GetStatsRequest())
        return any(st.counters.get("append_total", 0) > 0
                   for st in out.stats)

    assert same(stacks, run) is True


def test_http_error_status_mapping(stacks):
    def run(s):
        missing = s.http("GET", "/queries/does-not-exist")
        s.http("POST", "/streams", {"name": "dupes"})
        dup = s.http("POST", "/streams", {"name": "dupes"})
        s.admin("quota-set", scope="stream/dupes", records_per_s=0.001,
                burst_records=1)
        try:
            first = s.http("POST", "/streams/dupes/append",
                           {"records": [{"a": 1}]})
            code, err, headers = s.http_full(
                "POST", "/streams/dupes/append", {"records": [{"a": 2}]})
            return [missing, dup, first[0], code,
                    int(headers["Retry-After"]) >= 1,
                    err["retry_after_ms"] >= 1,
                    "retry_after_ms=" in err["error"]]
        finally:
            s.admin("quota-unset", scope="stream/dupes")

    out = same(stacks, run)
    assert out[0][0] == 404 and out[1][0] == 409
    assert out[2:] == [200, 429, True, True, True]


def test_client_retry_helper_rides_out_quota(stacks):
    def run(s):
        out = io.StringIO()
        client = s.client.Client(s.side.addr, out=out)
        client.execute("CREATE STREAM rlim;")
        s.admin("quota-set", scope="stream/rlim", records_per_s=2,
                burst_records=4)
        try:
            s.side.append("rlim", [{"a": i} for i in range(4)],
                          [BASE + i for i in range(4)])
            client.execute("INSERT INTO rlim (a) VALUES (99);")
            text = out.getvalue()
            return ["server error" in text, "lsn" in text,
                    client.retries > 0]
        finally:
            s.admin("quota-unset", scope="stream/rlim")
            client.close()

    assert same(stacks, run) == [False, True, True]


def test_flow_status_and_quota_admin_verbs(stacks):
    def run(s):
        s.admin("quota-set", scope="tenant/acme", records_per_s=9)
        try:
            got = s.admin("quota-get", scope="tenant/acme")
            listed = "tenant/acme" in s.admin("quota-list")
            status = s.admin("flow-status")
            view = [status["level"], status["active"],
                    sorted(status["signals"]),
                    status["quotas"]["tenant/acme"]["records_per_s"]]
        finally:
            s.admin("quota-unset", scope="tenant/acme")
        return [got, listed, view, s.admin("quota-get", scope="tenant/acme")]

    out = same(stacks, run)
    assert out[0]["records_per_s"] == 9 and out[1] and out[3]["unset"]


# ---- failover: a fenced leader's hint ----------------------------------------

class _FencedServicer:
    """Every RPC answers as a fenced store leader: UNAVAILABLE with the
    new leader's address in trailing metadata and in the message."""

    def __init__(self, hint: str):
        self.hint = hint
        self.hits = 0

    def __getattr__(self, name):
        def handler(request, context):
            self.hits += 1
            context.set_trailing_metadata((("x-leader-hint", self.hint),))
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"store leadership lost: fenced by epoch 2 "
                          f"(not_leader leader_hint={self.hint})")

        return handler


def fenced(stack):
    """A fenced fake leader of the stack's package whose hint points at
    the stack's real server: (grpc server, address, servicer)."""
    rpc = stack.side.m.rpc
    fake = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    svc = _FencedServicer(stack.side.addr)
    rpc.add_hstream_api_to_server(svc, fake)
    port = fake.add_insecure_port("127.0.0.1:0")
    fake.start()
    return fake, f"127.0.0.1:{port}", svc


def test_retry_policy_follows_hint_only_with_callback_and_hint(stacks):
    def run(s):
        r = s.retry

        class _Err(grpc.RpcError):
            def __init__(self, details="", md=()):
                self._d, self._md = details, md

            def code(self):
                return grpc.StatusCode.UNAVAILABLE

            def details(self):
                return self._d

            def trailing_metadata(self):
                return self._md

        hinted = _Err(md=(("x-leader-hint", "new:1"),))
        texted = _Err("x (not_leader leader_hint=new:2)")
        bare = _Err("connection reset")
        out = [r.leader_hint_from_error(e) for e in (hinted, texted, bare)]
        out.append(grpc.StatusCode.UNAVAILABLE in r.HINTED_RETRYABLE_CODES)
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] == 1:
                raise hinted
            return "ok"

        followed = []
        policy = r.RetryPolicy(attempts=3, sleep=lambda s: None)
        out += [policy.call(fn, on_leader_hint=followed.append),
                list(followed), policy.leader_follows]
        calls["n"] = 0
        with pytest.raises(grpc.RpcError):
            r.RetryPolicy(attempts=3, sleep=lambda s: None).call(fn)

        def always_bare():
            raise bare

        with pytest.raises(grpc.RpcError):
            policy.call(always_bare, on_leader_hint=followed.append)
        return out + [followed]

    assert same(stacks, run) == ["new:1", "new:2", None, True, "ok",
                                 ["new:1"], 1, ["new:1"]]


def test_client_follows_leader_hint_across_statements(stacks):
    def run(s):
        fake, addr, svc = fenced(s)
        out = io.StringIO()
        client = s.client.Client(addr, out=out)
        try:
            client.execute("CREATE STREAM failover_cli;")
            first = [client.addr == s.side.addr, client.retry.leader_follows,
                     svc.hits]
            streams = {x.stream_name for x in s.side.stub.ListStreams(
                s.side.pb.ListStreamsRequest()).streams}
            client.execute("CREATE STREAM failover_cli2;")
            return [first, "failover_cli" in streams,
                    "following hint" in out.getvalue(), svc.hits,
                    client.retry.leader_follows]
        finally:
            client.close()
            fake.stop(grace=1)

    assert same(stacks, run) == [[True, 1, 1], True, True, 1, 1]


def test_gateway_follows_leader_hint_and_rebinds(stacks):
    def run(s):
        fake, addr, svc = fenced(s)
        httpd, gw = s.gw_mod.serve_gateway(addr, port=0)
        base = f"http://127.0.0.1:{httpd.server_port}"
        try:
            created = list(s.http_full("POST", "/streams",
                                       {"name": "failover_gw"},
                                       base=base)[:2])
            out = [created, gw.leader_follows, gw.server_addr == s.side.addr,
                   svc.hits]
            streams = {x.stream_name for x in s.side.stub.ListStreams(
                s.side.pb.ListStreamsRequest()).streams}
            again = s.http_full("GET", "/streams", base=base)[0]
            return out + ["failover_gw" in streams, again, svc.hits]
        finally:
            httpd.shutdown()
            gw.close()
            fake.stop(grace=1)

    out = same(stacks, run)
    assert out == [[201, {"name": "failover_gw"}], 1, True, 1, True, 200, 1]


def test_gateway_surfaces_hint_when_retry_also_fails(stacks):
    def run(s):
        fake, addr, svc = fenced(s)
        svc.hint = addr
        gw = s.gw_mod.Gateway(addr)
        try:
            out = gw.handle("GET", "/streams", None)
            return [out[0], out[1]["leader_hint"] == addr,
                    len(out) == 2 or "x-follow-leader" not in (out[2] or {})]
        finally:
            gw.close()
            fake.stop(grace=1)

    assert same(stacks, run) == [503, True, True]
