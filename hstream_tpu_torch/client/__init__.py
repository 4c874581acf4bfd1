"""Interactive SQL REPL client.

Reference: the haskeline REPL in hstream/app/client.hs (216 LoC) —
reads SQL until ';', parses LOCALLY to classify the statement, then
routes: push queries (SELECT ... EMIT CHANGES) stream results over the
server-streaming RPC until Ctrl-C cancels (client.hs:117-132); DDL and
everything else go through dedicated RPCs / ExecuteQuery
(client.hs:91-116). Results render as aligned tables (the reference's
Format.hs table rendering).
"""

# A copy of hstream_tpu/client/__init__.py; the port imports nothing of
# the JAX package. The retry policy (client/retry.py) and the framed-append
# producer (client/producer.py) are copies of the reference's too.

from __future__ import annotations

import math
import sys
import uuid
from typing import Any, Iterable

import grpc

from hstream_tpu_torch.client.retry import RetryPolicy
from hstream_tpu_torch.client.producer import ColumnarProducer  # noqa: F401
# re-exported: the framed-append producer lives beside the
# SQL shell so `from hstream_tpu_torch.client import ColumnarProducer` works
from hstream_tpu_torch.common import records as rec
from hstream_tpu_torch.common.logger import REQUEST_ID_KEY
from hstream_tpu_torch.common.errors import SQLError
from hstream_tpu_torch.proto import api_pb2 as pb
from hstream_tpu_torch.proto.rpc import HStreamApiStub
from hstream_tpu_torch.sql import plans
from hstream_tpu_torch.sql.codegen import stream_codegen

BANNER = """hstream-tpu SQL shell — end with ';', Ctrl-C cancels a \
streaming query, \\q quits."""
PROMPT = "hstream> "
CONT = "       > "


def format_table(rows: list[dict[str, Any]]) -> str:
    """Aligned-column rendering (reference Format.hs)."""
    if not rows:
        return "(0 rows)"
    cols: list[str] = []
    for row in rows:
        for k in row:
            if k not in cols:
                cols.append(k)
    cells = [[_show(row.get(c)) for c in cols] for row in rows]
    widths = [max(len(c), *(len(r[i]) for r in cells))
              for i, c in enumerate(cols)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep,
           "|" + "|".join(f" {c:<{w}} " for c, w in zip(cols, widths))
           + "|", sep]
    for r in cells:
        out.append("|" + "|".join(
            f" {v:<{w}} " for v, w in zip(r, widths)) + "|")
    out.append(sep)
    out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


def _show(v: Any) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, float) and math.isfinite(v) and v == int(v):
        return str(int(v))
    return str(v)


class Client:
    """One connected SQL shell session."""

    def __init__(self, addr: str, out=None,
                 retry: RetryPolicy | None = None):
        self.addr = addr
        self.channel = grpc.insecure_channel(addr)
        self.stub = HStreamApiStub(self.channel)
        self.out = out or sys.stdout
        # RESOURCE_EXHAUSTED (quota/overload shed) retries with jittered
        # backoff honoring the server's retry-after hint; a NOT_LEADER
        # refusal (UNAVAILABLE + leader hint after a store failover)
        # rebinds the channel to the hinted leader and retries; every
        # other status surfaces immediately
        self.retry = retry or RetryPolicy()
        # correlation: every statement gets a fresh request id, stamped
        # into the gRPC metadata; kept here so "what id did my last
        # statement run under" is answerable (and testable)
        self.last_request_id: str | None = None

    def close(self) -> None:
        self.channel.close()

    @property
    def retries(self) -> int:
        """Total flow-control retries this session performed."""
        return self.retry.retries

    def _new_request_id(self) -> str:
        self.last_request_id = f"cli-{uuid.uuid4().hex[:12]}"
        return self.last_request_id

    def _metadata(self) -> tuple:
        # trace context: the request id doubles as the
        # trace id, and the client hop names itself as the parent span
        # — the server decides sampling from the id, so an unarmed
        # server pays one metadata compare
        from hstream_tpu_torch.common.tracing import (
            PARENT_SPAN_KEY,
            TRACE_ID_KEY,
        )

        rid = self._new_request_id()
        return ((REQUEST_ID_KEY, rid), (TRACE_ID_KEY, rid),
                (PARENT_SPAN_KEY, f"cli-{rid}"))

    def _follow_leader_hint(self, hint: str) -> None:
        """The server lost store leadership: reconnect to the hinted
        new leader so the retry (and every later statement) lands
        there (failover-aware clients)."""
        print(f"-- leader moved; following hint to {hint} --",
              file=self.out)
        old = self.channel
        self.addr = hint
        self.channel = grpc.insecure_channel(hint)
        self.stub = HStreamApiStub(self.channel)
        try:
            old.close()
        except Exception:  # noqa: BLE001 — the old channel is dead
            pass           # weight either way

    def _call(self, method: str, request):
        # resolve the RPC by NAME each attempt: a leader-hint follow
        # swaps self.stub, and a bound method would pin the old channel
        def attempt(req, **kw):
            return getattr(self.stub, method)(req, **kw)

        return self.retry.call(attempt, request,
                               metadata=self._metadata(),
                               on_leader_hint=self._follow_leader_hint)

    # ---- statement routing (client.hs:91-132) ---------------------------

    def execute(self, sql: str) -> None:
        try:
            plan = stream_codegen(sql)  # local parse first
        except SQLError as e:
            print(f"parse error: {e}", file=self.out)
            return
        try:
            if isinstance(plan, plans.SelectPlan) and plan.emit_changes:
                self._push_query(sql)
            elif isinstance(plan, plans.CreateViewPlan):
                v = self._call("CreateView",
                               pb.CreateViewRequest(sql=sql))
                print(f"view {v.view_id} created", file=self.out)
            elif isinstance(plan, plans.CreateSinkConnectorPlan):
                c = self._call("CreateSinkConnector",
                               pb.CreateSinkConnectorRequest(config=sql))
                print(f"connector {c.id} created", file=self.out)
            elif isinstance(plan, plans.CreatePlan):
                self._call("CreateStream", pb.Stream(
                    stream_name=plan.stream, replication_factor=1))
                print(f"stream {plan.stream} created", file=self.out)
            elif isinstance(plan, plans.TerminatePlan):
                req = (pb.TerminateQueriesRequest(all=True)
                       if plan.query_id is None else
                       pb.TerminateQueriesRequest(
                           query_ids=[plan.query_id]))
                done = self._call("TerminateQueries", req)
                print(f"terminated: {list(done.query_ids)}",
                      file=self.out)
            else:
                resp = self._call("ExecuteQuery",
                                  pb.CommandQuery(stmt_text=sql))
                rows = [rec.struct_to_dict(s) for s in resp.result_set]
                print(format_table(rows), file=self.out)
        except grpc.RpcError as e:
            print(f"server error: {e.details()}", file=self.out)

    def _push_query(self, sql: str) -> None:
        """Stream a push query until Ctrl-C (client.hs:117-132)."""
        call = self.stub.ExecutePushQuery(
            pb.CommandPushQuery(query_text=sql),
            metadata=self._metadata())
        print("-- streaming; Ctrl-C to stop --", file=self.out)
        try:
            for s in call:
                print(rec.struct_to_dict(s), file=self.out, flush=True)
        except KeyboardInterrupt:
            call.cancel()
            print("\n-- query cancelled --", file=self.out)
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.CANCELLED:
                print(f"server error: {e.details()}", file=self.out)

    # ---- REPL -----------------------------------------------------------

    def repl(self, input_lines: Iterable[str] | None = None) -> None:
        """Run the shell. `input_lines` makes it scriptable for tests;
        interactive mode uses readline-backed input()."""
        interactive = input_lines is None
        if interactive:
            try:
                import readline  # noqa: F401 — line editing/history
            except ImportError:
                pass
            print(BANNER, file=self.out)
        it = iter(input_lines) if input_lines is not None else None
        buf: list[str] = []
        while True:
            prompt = CONT if buf else PROMPT
            try:
                if it is None:
                    line = input(prompt)
                else:
                    line = next(it, None)
                    if line is None:
                        break
            except EOFError:
                break
            except KeyboardInterrupt:
                buf.clear()
                print("", file=self.out)
                continue
            line = line.rstrip("\n")
            if not buf and line.strip() in ("\\q", "quit", "exit"):
                break
            if not line.strip():
                continue
            buf.append(line)
            if line.rstrip().endswith(";"):
                sql = "\n".join(buf)
                buf.clear()
                self.execute(sql)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("hstream-tpu-client")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6570)
    ap.add_argument("-e", "--execute", default=None,
                    help="run one statement and exit")
    args = ap.parse_args(argv)
    client = Client(f"{args.host}:{args.port}")
    try:
        if args.execute:
            client.execute(args.execute)
        else:
            client.repl()
    finally:
        client.close()


if __name__ == "__main__":
    main()
