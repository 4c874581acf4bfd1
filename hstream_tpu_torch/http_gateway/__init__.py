"""REST gateway: HTTP façade over the gRPC API.

Reference: hstream-http-server (~1,057 LoC Servant) — one resource
module per entity (streams/queries/nodes/connectors/views/overview)
proxying a gRPC client, plus Swagger
(HStream/HTTP/Server/API.hs:33-54). Here a stdlib ThreadingHTTPServer
routes the same resources onto the HStreamApi stub; /overview surfaces
the server's stats holder via the GetStats RPC.

Every request carries a correlation id: the caller's ``X-Request-Id``
header when present, a generated one otherwise. The id is stamped into
the proxied gRPC call's metadata (handlers bind it into their log
records) and echoed back as a response header, so one id follows a
request client -> gateway -> handler.

Routes (JSON in/out unless noted):
  GET    /overview                    cluster summary + per-stream stats
                                      + flow/shed state + pipeline stages
  GET    /metrics                     Prometheus text exposition
  GET    /stats?entity=&interval=     per-entity rate-family tables
                                      (streams|subscriptions|queries x
                                      1min|10min|1h)
  GET    /cluster-stats?peers=        federated node load reports
  GET    /events?kind=&since=&limit=  event journal slice
  GET    /streams                     list
  POST   /streams {"name": ...}       create
  DELETE /streams/<name>              delete
  POST   /streams/<name>/append {"records": [{...}]}   append JSON rows
  POST   /streams/<name>/appendColumnar <raw frame>     framed columnar
                                        block (octet-stream)
  GET    /queries | POST /queries {"sql": ...} | GET|DELETE /queries/<id>
  POST   /queries/<id>/restart
  GET    /queries/<id>/health         OK/DEGRADED/STALLED rollup
  GET    /queries/<id>/trace          span ring, Chrome trace JSON
  GET    /queries/<id>/flightrec      flight-recorder postmortem bundles
  GET    /programs                    compiled-program inventory
  GET    /views | GET /views/<name> (pull query) | DELETE /views/<name>
  GET    /connectors | POST /connectors {"config": sql} | DELETE .../<id>
  GET    /nodes
  GET    /swagger.json
"""

# A copy of hstream_tpu/http_gateway/__init__.py; the port imports
# nothing of the JAX package.

from __future__ import annotations

import json
import re
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import grpc

from hstream_tpu_torch.common import locktrace
from hstream_tpu_torch.common import records as rec
from hstream_tpu_torch.common.logger import (
    REQUEST_ID_KEY,
    current_request_id,
    request_context,
)
from hstream_tpu_torch.proto import api_pb2 as pb
from hstream_tpu_torch.proto.rpc import HStreamApiStub

# Every status the server emits maps EXPLICITLY (the analyzer's
# errcontract pass enforces it): 500-by-default would let a new status
# silently degrade to an opaque 500 instead of failing the contract.
_STATUS = {
    grpc.StatusCode.NOT_FOUND: 404,
    grpc.StatusCode.ALREADY_EXISTS: 409,
    grpc.StatusCode.INVALID_ARGUMENT: 400,
    grpc.StatusCode.FAILED_PRECONDITION: 400,
    grpc.StatusCode.RESOURCE_EXHAUSTED: 429,
    grpc.StatusCode.ABORTED: 409,
    grpc.StatusCode.INTERNAL: 500,
    grpc.StatusCode.UNAVAILABLE: 503,
    # the port's NotPortedError: a feature the port does not serve yet
    grpc.StatusCode.UNIMPLEMENTED: 501,
}


class _CorrelatedStub:
    """Stub proxy stamping the active request's correlation id — and
    its trace context (trace id = request id, parent span =
    this gateway hop) — into every proxied gRPC call's metadata."""

    def __init__(self, stub: HStreamApiStub):
        self._stub = stub

    def __getattr__(self, name: str):
        fn = getattr(self._stub, name)

        def call(request, **kwargs):
            rid = current_request_id()
            if rid and "metadata" not in kwargs:
                from hstream_tpu_torch.common import tracing

                kwargs["metadata"] = (
                    (REQUEST_ID_KEY, rid),
                    (tracing.TRACE_ID_KEY, rid),
                    (tracing.PARENT_SPAN_KEY, f"gw-{rid}"))
            return fn(request, **kwargs)

        return call


class Gateway:
    """Routes HTTP requests onto a single shared gRPC stub.

    Failover-aware: when the server answers UNAVAILABLE with
    a leader hint (its replicated store was fenced by a promoted
    follower), the gateway rebinds its channel to the hinted leader
    and retries the request once instead of bouncing a 503 to every
    HTTP caller; later requests ride the rebound channel."""

    def __init__(self, server_addr: str):
        self.server_addr = server_addr
        self.leader_follows = 0  # rebinds performed after a hint
        # named traced lock: the rebind-once channel swap is
        # the gateway's one cross-thread rendezvous — witness-covered
        self._bind_lock = locktrace.lock("gateway.bind")
        self.channel = grpc.insecure_channel(server_addr)
        self.stub = _CorrelatedStub(HStreamApiStub(self.channel))
        # channels replaced by a leader-hint rebind, closed only at
        # gateway shutdown: another handler thread may still have an
        # RPC in flight on the old channel (e.g. a read the fenced
        # leader can still serve) — closing it mid-call would turn
        # that request into a spurious CANCELLED/500. Bounded by the
        # number of failovers over the gateway's lifetime.
        self._retired: list = []

    def close(self) -> None:
        with self._bind_lock:
            retired, self._retired = self._retired, []
        for ch in retired:
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass
        self.channel.close()

    def _follow_leader_hint(self, hint: str) -> None:
        """Rebind the shared channel/stub to the hinted new leader.
        Concurrent requests that all hit the fenced leader rebind
        once — the second caller finds the address already current."""
        with self._bind_lock:
            if hint == self.server_addr:
                return
            self._retired.append(self.channel)
            self.server_addr = hint
            self.channel = grpc.insecure_channel(hint)
            self.stub = _CorrelatedStub(HStreamApiStub(self.channel))
            self.leader_follows += 1

    # ---- resource handlers -----------------------------------------------

    def handle(self, method: str, path: str, body: dict | None,
               query: str = "") -> tuple[int, Any]:
        out = self._handle_once(method, path, body, query)
        hint = out[2].pop("x-follow-leader", None) if len(out) > 2 else None
        if hint is not None:
            # NOT_LEADER: follow the hint and retry this request once
            self._follow_leader_hint(hint)
            out = self._handle_once(method, path, body, query)
            if len(out) > 2:
                out[2].pop("x-follow-leader", None)
        return out

    def _handle_once(self, method: str, path: str, body: dict | None,
                     query: str = "") -> tuple[int, Any]:
        stub = self.stub
        try:
            if path == "/overview" and method == "GET":
                return 200, self._overview()
            if path == "/metrics" and method == "GET":
                # Prometheus scrape: raw text passthrough, not JSON
                from hstream_tpu_torch.stats.prometheus import CONTENT_TYPE

                text = self._admin("metrics")["text"]
                return 200, text, {"Content-Type": CONTENT_TYPE}
            if path == "/events" and method == "GET":
                from urllib.parse import parse_qs

                q = parse_qs(query or "")
                args: dict[str, Any] = {}
                if q.get("kind"):
                    args["kind"] = q["kind"][0]
                if q.get("since"):
                    args["since"] = int(q["since"][0])
                if q.get("limit"):
                    args["limit"] = int(q["limit"][0])
                return 200, self._admin("events", **args)["events"]
            if path == "/stats" and method == "GET":
                # Overview stats endpoint: per-entity rate
                # tables off the multi-level ladders — the JSON face
                # of `admin stats`
                from urllib.parse import parse_qs

                q = parse_qs(query or "")
                args = {}
                if q.get("entity"):
                    args["entity"] = q["entity"][0]
                if q.get("interval"):
                    args["interval"] = q["interval"][0]
                return 200, self._admin("stats", **args)
            if path == "/cluster-stats" and method == "GET":
                # federated per-node load reports (one JSON object per
                # node, keyed by node name)
                from urllib.parse import parse_qs

                q = parse_qs(query or "")
                args = {}
                if q.get("peers"):
                    args["peers"] = q["peers"][0]
                if q.get("timeout_s"):
                    args["timeout_s"] = float(q["timeout_s"][0])
                return 200, self._admin("cluster-stats", **args)
            if path == "/swagger.json" and method == "GET":
                return 200, SWAGGER
            if path == "/streams" and method == "GET":
                out = stub.ListStreams(pb.ListStreamsRequest())
                return 200, [{"name": s.stream_name,
                              "replication_factor": s.replication_factor}
                             for s in out.streams]
            if path == "/streams" and method == "POST":
                name = (body or {}).get("name")
                if not name:
                    return 400, {"error": "body needs {\"name\": ...}"}
                stub.CreateStream(pb.Stream(
                    stream_name=name,
                    replication_factor=(body or {}).get(
                        "replication_factor", 1)))
                return 201, {"name": name}
            m = re.fullmatch(r"/streams/([^/]+)", path)
            if m and method == "DELETE":
                stub.DeleteStream(pb.DeleteStreamRequest(
                    stream_name=m.group(1)))
                return 200, {"deleted": m.group(1)}
            m = re.fullmatch(r"/streams/([^/]+)/append", path)
            if m and method == "POST":
                rows = (body or {}).get("records")
                if not isinstance(rows, list) or not rows:
                    return 400, {"error":
                                 "body needs {\"records\": [{...}]}"}
                req = pb.AppendRequest(stream_name=m.group(1))
                for row in rows:
                    ts = row.pop("__time_ms", None) if isinstance(
                        row, dict) else None
                    req.records.append(
                        rec.build_record(row, publish_time_ms=ts))
                resp = stub.Append(req)
                return 200, {"record_ids": [
                    {"batch_id": r.batch_id, "batch_index": r.batch_index}
                    for r in resp.record_ids]}
            m = re.fullmatch(r"/streams/([^/]+)/appendColumnar", path)
            if m and method == "POST":
                # raw framed columnar block (application/octet-stream):
                # the HTTP face of the wire-speed append path — the
                # gateway proxies the bytes untouched, the server's
                # frame door does all validation (400 on a bad frame)
                if not isinstance(body, (bytes, bytearray)) or not body:
                    return 400, {"error": "body must be one framed "
                                          "columnar block (raw bytes)"}
                resp = stub.AppendColumnar(pb.AppendColumnarRequest(
                    stream_name=m.group(1), blocks=[bytes(body)]))
                return 200, {"rows": resp.rows, "record_ids": [
                    {"batch_id": r.batch_id, "batch_index": r.batch_index}
                    for r in resp.record_ids]}

            if path == "/queries" and method == "GET":
                out = stub.ListQueries(pb.ListQueriesRequest())
                return 200, [self._query_json(q) for q in out.queries]
            if path == "/queries" and method == "POST":
                sql = (body or {}).get("sql")
                if not sql:
                    return 400, {"error": "body needs {\"sql\": ...}"}
                q = stub.CreateQuery(pb.CreateQueryRequest(
                    query_text=sql, id=(body or {}).get("id", "")))
                return 201, self._query_json(q)
            m = re.fullmatch(r"/queries/([^/]+)", path)
            if m and method == "GET":
                q = stub.GetQuery(pb.GetQueryRequest(id=m.group(1)))
                return 200, self._query_json(q)
            if m and method == "DELETE":
                stub.DeleteQuery(pb.DeleteQueryRequest(id=m.group(1)))
                return 200, {"deleted": m.group(1)}
            m = re.fullmatch(r"/queries/([^/]+)/restart", path)
            if m and method == "POST":
                stub.RestartQuery(pb.RestartQueryRequest(id=m.group(1)))
                return 200, {"restarted": m.group(1)}
            m = re.fullmatch(r"/queries/([^/]+)/health", path)
            if m and method == "GET":
                # per-query health rollup: OK/DEGRADED/
                # STALLED + reasons, 404 for unknown queries
                return 200, self._admin("health", query=m.group(1))
            m = re.fullmatch(r"/queries/([^/]+)/trace", path)
            if m and method == "GET":
                # the query's span ring as Chrome trace-event JSON
                return 200, self._admin("trace-spans", scope=m.group(1))
            m = re.fullmatch(r"/queries/([^/]+)/flightrec", path)
            if m and method == "GET":
                # flight-recorder postmortem bundles — kept
                # past query deletion (404 only when none were captured)
                return 200, self._admin("flightrec", query=m.group(1))
            if path == "/programs" and method == "GET":
                # compiled-program inventory
                return 200, self._admin("programs")

            if path == "/views" and method == "GET":
                out = stub.ListViews(pb.ListViewsRequest())
                return 200, [{"name": v.view_id, "status": v.status,
                              "sql": v.sql} for v in out.views]
            m = re.fullmatch(r"/views/([^/]+)", path)
            if m and method == "GET":
                resp = stub.ExecuteQuery(pb.CommandQuery(
                    stmt_text=f"SELECT * FROM {m.group(1)};"))
                return 200, [rec.struct_to_dict(s)
                             for s in resp.result_set]
            if m and method == "DELETE":
                stub.DeleteView(pb.DeleteViewRequest(view_id=m.group(1)))
                return 200, {"deleted": m.group(1)}

            if path == "/connectors" and method == "GET":
                out = stub.ListConnectors(pb.ListConnectorsRequest())
                return 200, [{"id": c.id, "status": c.status,
                              "config": c.config}
                             for c in out.connectors]
            if path == "/connectors" and method == "POST":
                cfg = (body or {}).get("config")
                if not cfg:
                    return 400, {"error": "body needs {\"config\": sql}"}
                c = stub.CreateSinkConnector(
                    pb.CreateSinkConnectorRequest(
                        config=cfg, id=(body or {}).get("id", "")))
                return 201, {"id": c.id, "status": c.status}
            m = re.fullmatch(r"/connectors/([^/]+)", path)
            if m and method == "DELETE":
                stub.DeleteConnector(
                    pb.DeleteConnectorRequest(id=m.group(1)))
                return 200, {"deleted": m.group(1)}

            if path == "/nodes" and method == "GET":
                out = stub.ListNodes(pb.ListNodesRequest())
                return 200, [{"id": n.id, "address": n.address,
                              "port": n.port, "status": n.status,
                              "roles": list(n.roles)}
                             for n in out.nodes]
            return 404, {"error": f"no route {method} {path}"}
        except grpc.RpcError as e:
            code = _STATUS.get(e.code(), 500)
            if e.code() == grpc.StatusCode.UNAVAILABLE:
                from hstream_tpu_torch.client.retry import leader_hint_from_error

                hint = leader_hint_from_error(e)
                if hint:
                    # signal handle() to rebind + retry; if the retry
                    # fails too, the body still names the new leader
                    return (code, {"error": e.details() or "not leader",
                                   "leader_hint": hint},
                            {"x-follow-leader": hint})
            if code == 429:
                # flow-control refusal: surface the server's retry-after
                # hint as the standard header (seconds, rounded up)
                from hstream_tpu_torch.client.retry import (
                    retry_after_ms_from_error,
                )

                ms = retry_after_ms_from_error(e)
                headers = {"Retry-After":
                           str(max(1, -(-ms // 1000)) if ms else 1)}
                return (code, {"error": e.details() or str(e.code()),
                               "retry_after_ms": ms}, headers)
            return code, {"error": e.details() or str(e.code())}
        except (TypeError, ValueError, AttributeError, KeyError) as e:
            # malformed request bodies (wrong field types etc.) must get
            # a JSON 400, not a dropped connection + server traceback
            return 400, {"error": f"bad request: {e}"}
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            return 500, {"error": f"{type(e).__name__}: {e}"}

    def _query_json(self, q) -> dict:
        return {"id": q.id, "status": q.status,
                "created_time_ms": q.created_time_ms,
                "sql": q.query_text}

    def _admin(self, command: str, **kwargs) -> dict:
        resp = self.stub.SendAdminCommand(pb.AdminCommandRequest(
            command=command, args=rec.dict_to_struct(kwargs)))
        return json.loads(resp.result)

    def _overview(self) -> dict:
        """Cluster summary + the stats holder (reference Overview.hs —
        which never exposed stats; this does, via GetStats), plus the
        flow governor's shed/credit state and per-query pipeline stage
        occupancy — one scrape shows ingest, pipeline, and flow state
        together."""
        stub = self.stub
        streams = stub.ListStreams(pb.ListStreamsRequest()).streams
        queries = stub.ListQueries(pb.ListQueriesRequest()).queries
        views = stub.ListViews(pb.ListViewsRequest()).views
        conns = stub.ListConnectors(pb.ListConnectorsRequest()).connectors
        nodes = stub.ListNodes(pb.ListNodesRequest()).nodes
        stats = stub.GetStats(pb.GetStatsRequest())
        try:
            flow = self._admin("flow-status")
        except grpc.RpcError:
            flow = None
        try:
            read_cache = self._admin("read-cache")
        except grpc.RpcError:
            read_cache = None
        pipeline: dict[str, Any] = {}
        qids = [q.id for q in queries] + [f"view-{v.view_id}"
                                          for v in views]
        for qid in qids:
            try:
                trace = rec.struct_to_dict(stub.GetQueryTrace(
                    pb.GetQueryRequest(id=qid)))
            except grpc.RpcError:
                continue  # not running here
            stages = trace.get("pipeline")
            if stages:
                pipeline[qid] = {k: round(v, 4) if
                                 isinstance(v, float) else v
                                 for k, v in stages.items()}
        return {
            "streams": len(streams),
            "queries": len(queries),
            "views": len(views),
            "connectors": len(conns),
            "nodes": [{"id": n.id, "status": n.status} for n in nodes],
            "stats": [{
                "stream": s.stream_name,
                "counters": dict(s.counters),
                "rates": {k: round(v, 3) for k, v in s.rates.items()},
            } for s in stats.stats],
            "flow": flow,
            "read_cache": read_cache,
            "pipeline_stages": pipeline,
        }


def _make_handler(gw: Gateway):
    class Handler(BaseHTTPRequestHandler):
        def _run(self, method: str) -> None:
            from urllib.parse import unquote, urlsplit

            # split query string, decode %-escapes in resource names
            # (before the body read: the framed-append route takes its
            # body RAW, everything else parses JSON)
            parts = urlsplit(self.path)
            path = unquote(parts.path)
            body = None
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                raw = self.rfile.read(length)
                if path.rstrip("/").endswith("/appendColumnar"):
                    body = raw  # one framed columnar block, raw bytes
                else:
                    try:
                        body = json.loads(raw)
                    except ValueError:
                        self._send(400, {"error": "invalid JSON body"})
                        return
            # correlation: honor the caller's id, mint one otherwise;
            # the id rides the proxied gRPC metadata and echoes back
            rid = (self.headers.get("X-Request-Id")
                   or f"gw-{uuid.uuid4().hex[:12]}")
            self._rid = rid
            with request_context(rid):
                out = gw.handle(method, path.rstrip("/") or path, body,
                                query=parts.query)
            # (code, payload) or (code, payload, extra-headers)
            code, payload = out[0], out[1]
            headers = out[2] if len(out) > 2 else None
            self._send(code, payload, headers)

        def _send(self, code: int, payload: Any,
                  headers: dict[str, str] | None = None) -> None:
            headers = dict(headers or {})
            if isinstance(payload, (str, bytes)):
                # raw passthrough (/metrics text exposition)
                data = (payload.encode()
                        if isinstance(payload, str) else payload)
                ctype = headers.pop("Content-Type", "text/plain")
            else:
                data = json.dumps(payload).encode()
                ctype = headers.pop("Content-Type", "application/json")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            rid = getattr(self, "_rid", None)
            if rid:
                self.send_header("X-Request-Id", rid)
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            self._run("GET")

        def do_POST(self):  # noqa: N802
            self._run("POST")

        def do_DELETE(self):  # noqa: N802
            self._run("DELETE")

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve_gateway(server_addr: str, host: str = "127.0.0.1",
                  port: int = 6580) -> tuple[ThreadingHTTPServer, Gateway]:
    """Start the gateway; returns (httpd, gateway). Caller owns
    shutdown. Port 0 picks a free port (httpd.server_port)."""
    gw = Gateway(server_addr)
    httpd = ThreadingHTTPServer((host, port), _make_handler(gw))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, gw


SWAGGER = {
    "openapi": "3.0.0",
    "info": {"title": "hstream-tpu HTTP gateway", "version": "1.0"},
    "paths": {
        "/overview": {"get": {"summary": "cluster summary + stats + "
                                         "flow + pipeline stages"}},
        "/metrics": {"get": {"summary":
                             "Prometheus text exposition"}},
        "/events": {"get": {"summary": "event journal slice "
                                       "(kind/since/limit)"}},
        "/stats": {"get": {"summary": "per-entity rate-family tables "
                                      "(entity=streams|subscriptions|"
                                      "queries, interval=1min|10min|"
                                      "1h)"}},
        "/cluster-stats": {"get": {"summary": "federated node load "
                                              "reports merged across "
                                              "peers/followers"}},
        "/streams": {"get": {"summary": "list streams"},
                     "post": {"summary": "create stream"}},
        "/streams/{name}": {"delete": {"summary": "delete stream"}},
        "/streams/{name}/append": {
            "post": {"summary": "append JSON records"}},
        "/streams/{name}/appendColumnar": {
            "post": {"summary": "append one framed columnar block "
                                "(raw bytes, colframe wire format)"}},
        "/queries": {"get": {"summary": "list queries"},
                     "post": {"summary": "create push query"}},
        "/queries/{id}": {"get": {"summary": "get query"},
                          "delete": {"summary": "delete query"}},
        "/queries/{id}/restart": {"post": {"summary": "restart query"}},
        "/queries/{id}/health": {
            "get": {"summary": "health rollup: OK/DEGRADED/STALLED "
                               "with reasons + freshness evidence"}},
        "/queries/{id}/trace": {
            "get": {"summary": "span ring as Chrome trace-event JSON "
                               "(needs --trace-sample > 0)"}},
        "/queries/{id}/flightrec": {
            "get": {"summary": "flight-recorder postmortem bundles "
                               "(captured at STALLED / crash-loop "
                               "edges; survive query deletion)"}},
        "/programs": {
            "get": {"summary": "compiled-program inventory: every "
                               "compile of the server process"}},
        "/views": {"get": {"summary": "list views"}},
        "/views/{name}": {"get": {"summary": "pull-query the view"},
                          "delete": {"summary": "drop view"}},
        "/connectors": {"get": {"summary": "list connectors"},
                        "post": {"summary": "create sink connector"}},
        "/connectors/{id}": {"delete": {"summary": "delete connector"}},
        "/nodes": {"get": {"summary": "list server nodes"}},
    },
}


def main(argv=None) -> None:
    import argparse
    import signal

    ap = argparse.ArgumentParser("hstream-tpu-http-gateway")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=6580)
    ap.add_argument("--server", default="127.0.0.1:6570",
                    help="gRPC server address to proxy")
    args = ap.parse_args(argv)
    httpd, gw = serve_gateway(args.server, args.host, args.port)
    print(f"http gateway on {args.host}:{httpd.server_port} -> "
          f"{args.server}")
    ev = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: ev.set())
    signal.signal(signal.SIGTERM, lambda *a: ev.set())
    ev.wait()
    httpd.shutdown()
    gw.close()


if __name__ == "__main__":
    main()
