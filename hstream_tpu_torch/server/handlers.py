"""The HStreamApi handler table: the reference's 35 RPCs plus the
framed columnar append pair (AppendColumnar / AppendColumnarStream).

Reference: `handlers` wires the full service (Handler.hs:96-174); stream
CRUD + append at Handler.hs:187-231; `executeQueryHandler` dispatches
one-shot plans incl. SelectView slicing (Handler.hs:259-346);
`executePushQueryHandler` = codegen -> temp sink stream -> persist ->
fork task -> stream Structs to the client (Handler.hs:349-415);
subscription machinery at Handler.hs:420-935. Exceptions map to gRPC
statuses like `defaultExceptionHandle` (Server/Exception.hs:27-50).
"""

# A copy of hstream_tpu/server/handlers.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Iterable

import grpc
from google.protobuf import empty_pb2, struct_pb2

from hstream_tpu_torch.common import colframe, columnar
from hstream_tpu_torch.common import records as rec
from hstream_tpu_torch.common.errors import (
    HStreamError,
    NotPortedError,
    QueryNotFound,
    ServerError,
    SQLValidateError,
    StreamNotFound,
)
from hstream_tpu_torch.common.idgen import gen_unique
from hstream_tpu_torch.common.logger import (
    REQUEST_ID_KEY,
    current_request_id,
    get_logger,
    request_context,
)
from hstream_tpu_torch.common import tracing
from hstream_tpu_torch.proto import api_pb2 as pb
from hstream_tpu_torch.server.context import ServerContext
from hstream_tpu_torch.server import scheduler
from hstream_tpu_torch.server.persistence import (
    QUERY_PUSH,
    QUERY_STREAM,
    QUERY_VIEW,
    ConnectorInfo,
    QueryInfo,
    TaskStatus,
    now_ms,
)
from hstream_tpu_torch.server.subscriptions import RecId
from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.server.tasks import (
    QueryTask,
    parse_snapshot_pointer,
    snapshot_key,
    snapshot_slot_key,
    stream_sink,
)
from hstream_tpu_torch.server.views import Materialization, serve_select_view
from hstream_tpu_torch.sql import plans
from hstream_tpu_torch.sql.codegen import explain_text, stream_codegen
from hstream_tpu_torch.store.api import LSN_MIN, Compression, DataBatch
from hstream_tpu_torch.store.checkpoint import CheckpointedReader
from hstream_tpu_torch.store.streams import StreamType

log = get_logger("server")

# LDQuery-lite internal tables (reference hs_ldquery.cpp): plain SQL
# over server metadata through ExecuteQuery
VIRTUAL_TABLES = frozenset({
    "__streams__", "__queries__", "__subscriptions__", "__views__",
    "__connectors__", "__stats__"})


def _connectors_not_ported() -> None:
    raise NotPortedError("sink connectors (CREATE SINK CONNECTOR)", "A5c")


def _abort_hstream(context, e: HStreamError) -> None:
    """Map a typed error to its gRPC status; flow-control refusals also
    carry the retry-after hint, and NOT_LEADER refusals the new
    leader's address, as trailing metadata so clients can back off /
    follow without parsing the message text."""
    md = []
    ra = getattr(e, "retry_after_ms", None)
    if ra is not None:
        md.append(("retry-after-ms", str(int(ra))))
    hint = getattr(e, "leader_hint", None)
    if hint:
        md.append(("x-leader-hint", str(hint)))
    if md:
        context.set_trailing_metadata(tuple(md))
    context.abort(e.grpc_status, str(e) or type(e).__name__)


# RPCs measured into fixed-bucket latency histograms: the
# metric names live in the stats registry; the label comes from the
# request (stream for data-plane RPCs, leading keyword for SQL)
_RPC_HISTOGRAMS = {
    "Append": "append_latency_ms",
    "AppendColumnar": "append_latency_ms",
    # AppendColumnarStream observes its own latency inside the handler:
    # _finish_rpc only sees the request ITERATOR, which carries no
    # stream name for the label
    "Fetch": "fetch_latency_ms",
    "ExecuteQuery": "sql_execute_latency_ms",
}

# profile-first discipline: the framed append path reports
# where its milliseconds live, per stage, into the stage histograms —
# frame/block validation, flow admission, lane handoff, store wait
APPEND_STAGES = ("append_decode", "append_admit", "append_handoff",
                 "append_store")


def _request_id_from(context) -> str:
    try:
        for k, v in context.invocation_metadata() or ():
            if k == REQUEST_ID_KEY:
                return str(v)
    except Exception:  # noqa: BLE001 — metadata is best-effort
        pass
    return ""


def _trace_from(context, rid: str) -> tuple[str, str]:
    """(trace id, parent span id) of the incoming request: the
    x-trace-id metadata when stamped, else the request id itself — the
    correlation id IS the trace id, so a request traced
    nowhere upstream still gets a coherent trace."""
    trace_id, parent = rid, ""
    try:
        for k, v in context.invocation_metadata() or ():
            if k == tracing.TRACE_ID_KEY:
                trace_id = str(v)
            elif k == tracing.PARENT_SPAN_KEY:
                parent = str(v)
    except Exception:  # noqa: BLE001 — metadata is best-effort
        pass
    return trace_id, parent


def _trace_scope(request, result) -> str:
    """The ring a handler span lands in: the query id it touched (or
    created), else the target stream/subscription, else the shared
    _rpc scope."""
    for obj in (result, request):
        for attr in ("id", "stream_name", "subscription_id"):
            v = getattr(obj, attr, "")
            if isinstance(v, str) and v:
                return v
    return "_rpc"


def _producer_from(context) -> tuple[str, int] | None:
    """SQL INSERT idempotence stamp: Append carries the producer on the
    request proto; ExecuteQuery carries it as `x-producer-id` /
    `x-producer-seq` metadata (the statement text stays portable). A
    malformed seq on a stamped request is refused INVALID_ARGUMENT —
    silently running the INSERT unstamped would break the exactly-once
    contract the client thinks it has (its retry would double-append)."""
    pid, seq, bad = "", None, None
    try:
        for k, v in context.invocation_metadata() or ():
            if k == "x-producer-id":
                pid = str(v)
            elif k == "x-producer-seq":
                try:
                    seq = int(v)
                except ValueError:
                    bad = str(v)
    except Exception:  # noqa: BLE001 — metadata is best-effort
        return None
    if pid and bad is not None:
        raise SQLValidateError(
            f"malformed x-producer-seq {bad!r} on a stamped request "
            f"(producer {pid!r}): must be a base-10 integer")
    return (pid, seq) if pid and seq is not None else None


def _dedup_append(ctx, logid: int, payloads, compression,
                  producer_id: str, producer_seq: int
                  ) -> tuple[int, int, bool]:
    """Producer-stamped append against either store shape: the
    replicated store runs the lookup+log+apply in ONE critical section
    (and the stamp rides the op-log so every replica derives the same
    window); a single-node store gets the same atomicity from the
    context-level dedup lock. Returns (lsn, n_records, was_dup)."""
    store = ctx.store
    if hasattr(store, "append_batch_dedup"):
        return store.append_batch_dedup(
            logid, payloads, compression,
            producer_id=producer_id, producer_seq=producer_seq)
    from hstream_tpu_torch.store import dedup

    return dedup.guarded_append(store, ctx.dedup_lock, logid, payloads,
                                compression, producer_id, producer_seq)


def _rpc_hist_label(rpc: str, request) -> str:
    if rpc == "ExecuteQuery":
        txt = (getattr(request, "stmt_text", "") or "").lstrip()
        return txt.split(None, 1)[0].lower() if txt else ""
    return (getattr(request, "stream_name", "")
            or getattr(request, "subscription_id", ""))


def _finish_rpc(self, fn_name: str, request, rid: str,
                t0: float) -> None:
    """Post-RPC bookkeeping shared by every unary handler: latency
    histogram + the correlated slow-request log line."""
    dur_ms = (time.perf_counter() - t0) * 1e3
    metric = _RPC_HISTOGRAMS.get(fn_name)
    if metric is not None:
        try:
            self.ctx.stats.observe(metric,
                                   _rpc_hist_label(fn_name, request),
                                   dur_ms)
        except Exception:  # noqa: BLE001 — metrics must not fail RPCs
            pass
    slow_ms = getattr(self.ctx, "slow_request_ms", None)
    if slow_ms is not None and dur_ms >= slow_ms:
        log.warning("slow request: %s took %.1fms (threshold %.0fms)%s",
                    fn_name, dur_ms, slow_ms,
                    "" if rid else " [no request id]")


def unary(fn):
    @functools.wraps(fn)
    def wrapped(self, request, context):
        rid = _request_id_from(context)
        t0 = time.perf_counter()
        # trace context: one branch when tracing is
        # disarmed; when the trace id samples in, the handler body runs
        # under a span scope so nested probes (append stages, delivery)
        # parent correctly, and the RPC span lands on completion
        tr = self.ctx.tracing
        span = None  # (trace_id, span_id, parent_id)
        if tr.active:
            trace_id, parent = _trace_from(context, rid)
            if tr.sampled(trace_id):
                span = (trace_id, tracing.new_span_id(), parent)
        result = None
        with request_context(rid):
            try:
                if FAULTS.active:  # chaos: fail/delay at handler entry
                    FAULTS.point("rpc.handler")
                if span is None:
                    result = fn(self, request, context)
                else:
                    with tracing.span_scope(span[0], span[1]):
                        result = fn(self, request, context)
                return result
            except HStreamError as e:
                _abort_hstream(context, e)
            except grpc.RpcError:
                raise
            except Exception as e:  # noqa: BLE001 — boundary mapping
                log.exception("handler %s failed", fn.__name__)
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")
            finally:
                _finish_rpc(self, fn.__name__, request, rid, t0)
                if span is not None:
                    dur_ms = (time.perf_counter() - t0) * 1e3
                    try:
                        tr.record_span(
                            _trace_scope(request, result), "rpc",
                            trace_id=span[0], span_id=span[1],
                            parent_id=span[2],
                            t0_ms=time.time() * 1e3 - dur_ms,
                            dur_ms=dur_ms, rpc=fn.__name__,
                            ok=result is not None)
                    except Exception:  # noqa: BLE001 — span plumbing
                        pass           # must never fail the RPC

    return wrapped


def streaming(fn):
    @functools.wraps(fn)
    def wrapped(self, request, context):
        with request_context(_request_id_from(context)):
            try:
                yield from fn(self, request, context)
            except HStreamError as e:
                _abort_hstream(context, e)
            except grpc.RpcError:
                raise
            except Exception as e:  # noqa: BLE001
                log.exception("handler %s failed", fn.__name__)
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")

    return wrapped


def _struct(row: dict[str, Any]) -> struct_pb2.Struct:
    return rec.dict_to_struct(row)


def _reject_virtual_name(kind: str, name: str) -> None:
    """CREATE STREAM/VIEW names must not shadow the reserved virtual
    tables: a user view named __streams__ would be unreachable (SELECT
    routes virtual names to metadata) and a stream of that name would
    silently split reads between the two."""
    if name in VIRTUAL_TABLES:
        raise ServerError(
            f"{kind} name {name!r} collides with a reserved virtual "
            f"table; pick another name")


class HStreamApiServicer:
    def __init__(self, ctx: ServerContext):
        self.ctx = ctx
        # self-healing: the supervisor restarts dead tasks through the
        # same snapshot-resume path RestartQuery uses
        sup = getattr(ctx, "supervisor", None)
        if sup is not None:
            sup.resume_fn = self._resume_query
        # the placer adopts a dead peer's queries through the SAME
        # snapshot-resume path (live failover adoption)
        placer = getattr(ctx, "placer", None)
        if placer is not None:
            placer.resume_fn = self._resume_query

    # ---- misc ---------------------------------------------------------------

    @unary
    def Echo(self, request, context):
        return pb.EchoResponse(msg=request.msg)

    # ---- streams ------------------------------------------------------------

    @unary
    def CreateStream(self, request, context):
        _reject_virtual_name("stream", request.stream_name)
        self.ctx.streams.create_stream(
            request.stream_name,
            replication_factor=max(request.replication_factor, 1))
        return request

    @unary
    def DeleteStream(self, request, context):
        self.ctx.streams.delete_stream(request.stream_name)
        return empty_pb2.Empty()

    @unary
    def ListStreams(self, request, context):
        out = pb.ListStreamsResponse()
        for name in self.ctx.streams.find_streams():
            meta = self.ctx.streams.stream_meta(name)
            out.streams.append(pb.Stream(
                stream_name=name,
                replication_factor=meta.get("replication_factor", 1)))
        return out

    @unary
    def Append(self, request, context):
        ctx = self.ctx
        logid = ctx.streams.get_logid(request.stream_name)
        now = now_ms()
        payloads = []
        nbytes = 0
        for r in request.records:
            # the batch default timestamp is
            # stamped once (only into headers that carry none), and
            # large payloads are spliced around a header-only
            # serialize instead of re-walked whole (records.py)
            data = rec.record_bytes(r, default_ts=now)
            payloads.append(data)
            nbytes += len(data)
        if not payloads:
            raise ServerError("empty append")
        # flow control: one branch when no quota is set and the overload
        # detector is quiet (ctx.flow.active is a plain attribute)
        if ctx.flow.active:
            ctx.flow.admit_append(request.stream_name, len(payloads),
                                  nbytes)
        compression = getattr(ctx, "append_compression", Compression.NONE)
        try:
            if request.producer_id:
                # idempotent append: the (producer_id, seq)
                # stamp rides the replicated entry, so a retry — even
                # one that straddles a leader failover — is answered
                # with the ORIGINAL record ids on every replica
                lsn, n, dup = _dedup_append(
                    ctx, logid, payloads, compression,
                    request.producer_id, request.producer_seq)
            else:
                lsn, n, dup = ctx.store.append_batch(
                    logid, payloads, compression), len(payloads), False
        except Exception:
            # admitted but not stored (store I/O, replication broken,
            # seq behind the dedup window): the failure counter
            # separates this from quota refusals
            ctx.stats.stream_stat_add("append_failed",
                                      request.stream_name)
            raise
        if dup:
            ctx.stats.stream_stat_add("append_deduped",
                                      request.stream_name)
        else:
            ctx.stats.note_append(request.stream_name, len(payloads),
                                  nbytes)
        out = pb.AppendResponse(stream_name=request.stream_name,
                                duplicate=dup)
        for i in range(n):
            out.record_ids.append(pb.RecordId(batch_id=lsn, batch_index=i))
        return out

    # ---- framed columnar append -------------------------

    def _observe_append_stage(self, stage: str, seconds: float) -> None:
        try:
            self.ctx.stats.observe("stage_latency_ms", stage,
                                   seconds * 1e3)
        except Exception:  # noqa: BLE001 — metrics must not fail RPCs
            pass

    def _trace_stage_span(self, scope: str, stage: str,
                          dur_s: float) -> None:
        """One child span under the active sampled request (no-op when
        tracing is disarmed or the request wasn't sampled)."""
        tr = self.ctx.tracing
        if not tr.active:
            return
        sctx = tracing.current_span()
        if sctx is None:
            return
        dur_ms = dur_s * 1e3
        try:
            tr.record_span(scope, stage, trace_id=sctx[0],
                           span_id=tracing.new_span_id(),
                           parent_id=sctx[1],
                           t0_ms=time.time() * 1e3 - dur_ms,
                           dur_ms=dur_ms)
        except Exception:  # noqa: BLE001 — span plumbing must never
            pass           # fail the RPC

    def _bind_task_trace(self, task, scope: str) -> None:
        """Attach a newly launched query task to the creating request's
        sampled trace: its pipeline-stage timings then land as spans in
        the query's ring, parented on the handler span."""
        tr = self.ctx.tracing
        sctx = tracing.current_span()
        if tr.active and sctx is not None:
            task.tracer.bind_trace(tr, scope=scope, trace_id=sctx[0],
                                   parent_id=sctx[1])

    # contract: dispatches<=0 fetches<=0
    def _append_blocks(self, stream: str, blocks
                       ) -> tuple["object", int, int, int]:
        """Validate-ALL-then-submit for one request's framed blocks:
        every frame is opened and its columnar block bounds-checked
        BEFORE any byte is handed to the append front, and the whole
        request goes to the store as ONE batch (like the protobuf
        Append path) — so neither a bad frame NOR a store failure can
        partially ingest a request. Returns (future, n_blocks, rows,
        nbytes); the future resolves to the request's shared LSN
        (blocks are addressed (lsn, block_index))."""
        ctx = self.ctx
        logid = ctx.streams.get_logid(stream)
        if not blocks:
            raise ServerError("empty append")
        t0 = time.perf_counter()
        wraps: list[bytes] = []
        rows = 0
        nbytes = 0
        for b in blocks:
            payload, n, last_ts = colframe.open_block(b)
            # the store sees NORMAL columnar records: one header
            # serialize + one memcpy each (no protobuf round-trip),
            # read side unchanged
            wraps.append(rec.wrap_raw_record(payload, last_ts))
            rows += n
            nbytes += len(b)
        t1 = time.perf_counter()
        if ctx.flow.active:
            ctx.flow.admit_append(stream, rows, nbytes)
        t2 = time.perf_counter()
        # honor the operator's storage-compression knob like the
        # protobuf Append path does
        compression = getattr(ctx, "append_compression",
                              Compression.NONE)
        fut = ctx.append_front.submit(logid, wraps, compression)
        t3 = time.perf_counter()
        self._observe_append_stage("append_decode", t1 - t0)
        self._observe_append_stage("append_admit", t2 - t1)
        self._observe_append_stage("append_handoff", t3 - t2)
        if ctx.tracing.active:
            self._trace_stage_span(stream, "append_decode", t1 - t0)
            self._trace_stage_span(stream, "append_admit", t2 - t1)
            self._trace_stage_span(stream, "append_handoff", t3 - t2)
        return fut, len(wraps), rows, nbytes

    def _settle_appends(self, stream: str, entries: list
                        ) -> tuple[list[tuple[int, int]], int, int, int,
                                   BaseException | None]:
        """Wait out EVERY submitted request batch (never abandon a
        future — an unretrieved exception is log noise and an
        uncounted store mutation): returns (record ids as (lsn, idx),
        landed_blocks, landed_rows, landed_bytes, first_error).
        Failures count append_failed."""
        t0 = time.perf_counter()
        ids: list[tuple[int, int]] = []
        blocks = rows = nbytes = 0
        err: BaseException | None = None
        for fut, nblocks, r, nb in entries:
            try:
                lsn = fut.result(timeout=60)
            except Exception as e:  # noqa: BLE001 — surfaced after
                # every sibling batch settles
                self.ctx.stats.stream_stat_add("append_failed", stream)
                if err is None:
                    err = e
            else:
                ids.extend((lsn, i) for i in range(nblocks))
                blocks += nblocks
                rows += r
                nbytes += nb
        dt = time.perf_counter() - t0
        self._observe_append_stage("append_store", dt)
        if self.ctx.tracing.active:
            self._trace_stage_span(stream, "append_store", dt)
        return ids, blocks, rows, nbytes, err

    def _note_landed(self, stream: str, blocks: int, rows: int,
                     nbytes: int) -> None:
        """Metrics for blocks that durably landed — recorded even when
        the RPC itself aborts, so counters never undercount the store."""
        if blocks:
            self.ctx.stats.note_append(stream, blocks, nbytes)
            self.ctx.stats.stream_stat_add("append_columnar_rows",
                                           stream, rows)

    @unary
    def AppendColumnar(self, request, context):
        """Framed columnar append: bounds-check + handoff, no
        per-record protobuf work (the staging layout the encode
        workers consume arrives AS the wire format)."""
        stream = request.stream_name
        entry = self._append_blocks(stream, request.blocks)
        ids, blocks, rows, nbytes, err = self._settle_appends(stream,
                                                              [entry])
        self._note_landed(stream, blocks, rows, nbytes)
        if err is not None:
            raise err
        out = pb.AppendColumnarResponse(stream_name=stream, rows=rows)
        for lsn, idx in ids:
            out.record_ids.append(pb.RecordId(batch_id=lsn,
                                              batch_index=idx))
        return out

    @unary
    def AppendColumnarStream(self, request_iterator, context):
        """Client-streaming framed append: N micro-batches amortize ONE
        RPC. Each request message is validated atomically and its
        blocks submitted to the append front, overlapping the next
        message's receive with the previous blocks' store wait; the
        single response carries every block's record id in submission
        order. A bad frame aborts the call — its own request's blocks
        never land; EARLIER requests were already durably appended
        (their rows stay counted, and their ids would have been acked
        had the stream completed)."""
        ctx = self.ctx
        t_rpc = time.perf_counter()
        stream = None
        pending: list = []    # one (future, blocks, rows, bytes)/request
        ids: list[tuple[int, int]] = []
        landed = [0, 0, 0]           # blocks, rows, bytes

        def settle(limit: int) -> None:
            while len(pending) > limit:
                got, b, r, nb, err = self._settle_appends(
                    stream, [pending.pop(0)])
                ids.extend(got)
                landed[0] += b
                landed[1] += r
                landed[2] += nb
                if err is not None:
                    raise err

        try:
            for req in request_iterator:
                if stream is None:
                    stream = req.stream_name
                    if not stream:
                        raise ServerError(
                            "first AppendColumnarStream request must "
                            "name the stream")
                elif req.stream_name and req.stream_name != stream:
                    raise ServerError(
                        "AppendColumnarStream carries ONE stream per "
                        f"call; got {req.stream_name!r} after "
                        f"{stream!r}")
                pending.append(self._append_blocks(stream, req.blocks))
                # bound in-flight memory without stalling the pipeline
                settle(128)
            if stream is None:
                raise ServerError("empty append stream")
            settle(0)
        finally:
            # aborting or not, every submitted request settles: what
            # durably landed is counted, no future is abandoned
            if pending and stream is not None:
                got, b, r, nb, _err = self._settle_appends(stream,
                                                           pending)
                ids.extend(got)
                landed[0] += b
                landed[1] += r
                landed[2] += nb
            if stream is not None:
                self._note_landed(stream, *landed)
        try:
            # whole-call latency under the STREAM label (see the
            # _RPC_HISTOGRAMS note)
            ctx.stats.observe("append_latency_ms", stream,
                              (time.perf_counter() - t_rpc) * 1e3)
        except Exception:  # noqa: BLE001 — metrics must not fail RPCs
            pass
        out = pb.AppendColumnarResponse(stream_name=stream,
                                        rows=landed[1])
        for lsn, idx in ids:
            out.record_ids.append(pb.RecordId(batch_id=lsn,
                                              batch_index=idx))
        return out

    @unary
    def CreateQueryStream(self, request, context):
        sql = request.query_statement
        plan = stream_codegen(sql)
        if isinstance(plan, plans.SelectPlan):
            select = plan
        elif isinstance(plan, plans.CreateBySelectPlan):
            select = plan.select
        else:
            raise ServerError("CreateQueryStream needs a SELECT statement")
        name = request.query_stream.stream_name
        _reject_virtual_name("stream", name)
        self.ctx.streams.create_stream(
            name,
            replication_factor=max(request.query_stream.replication_factor,
                                   1))
        info = self._launch_query(select, sql, QUERY_STREAM, sink_stream=name)
        return pb.CreateQueryStreamResponse(
            query_stream=request.query_stream,
            stream_query=self._query_pb(info))

    # ---- SQL ----------------------------------------------------------------

    @streaming
    def ExecutePushQuery(self, request, context):
        """codegen -> temp sink stream -> fork task -> stream Structs
        (Handler.hs:349-415)."""
        ctx = self.ctx
        plan = stream_codegen(request.query_text)
        if not isinstance(plan, plans.SelectPlan) or not plan.emit_changes:
            raise ServerError(
                "ExecutePushQuery expects SELECT ... EMIT CHANGES")
        if not ctx.streams.stream_exists(plan.source):
            raise StreamNotFound(plan.source)
        query_id = f"q{gen_unique()}"
        sink_name = query_id
        ctx.streams.create_stream(sink_name, stream_type=StreamType.TEMP)
        info = self._launch_query(plan, request.query_text, QUERY_PUSH,
                                  sink_stream=sink_name,
                                  sink_type=StreamType.TEMP,
                                  query_id=query_id)
        task = ctx.running_queries.get(query_id)

        def cleanup():
            # handlePushQueryCanceled (Handler.hs:376-377)
            if task is not None:
                task.stop()
            try:
                ctx.persistence.set_query_status(query_id,
                                                 TaskStatus.TERMINATED)
            except Exception:
                pass

        context.add_callback(cleanup)
        sink_logid = ctx.streams.get_logid(sink_name, StreamType.TEMP)
        reader = ctx.store.new_reader()
        reader.set_timeout(100)
        reader.start_reading(sink_logid, LSN_MIN)
        while context.is_active():
            try:
                info_now = ctx.persistence.get_query(query_id)
            except QueryNotFound:
                break
            if info_now.status in (TaskStatus.TERMINATED,
                                   TaskStatus.CONNECTION_ABORT):
                break
            for item in reader.read(256):
                if not isinstance(item, DataBatch):
                    continue
                for payload in item.payloads:
                    record = rec.parse_record(payload)
                    if record.header.flag == rec.pb.RECORD_FLAG_RAW:
                        # vectorized sink emission: one columnar record
                        # per changelog batch (tasks.stream_sink)
                        for row in (columnar.payload_rows(record.payload)
                                    or ()):
                            yield rec.dict_to_struct(row)
                        continue
                    s = rec.payload_to_struct(record)
                    if s is not None:
                        yield s

    @unary
    def ExecuteQuery(self, request, context):
        plan = stream_codegen(request.stmt_text)
        rows = self._execute_plan(plan, request.stmt_text,
                                  producer=_producer_from(context))
        out = pb.CommandQueryResponse()
        for row in rows:
            out.result_set.append(_struct(row))
        return out

    # ---- query lifecycle ----------------------------------------------------

    @unary
    def CreateQuery(self, request, context):
        plan = stream_codegen(request.query_text)
        if not isinstance(plan, plans.SelectPlan) or not plan.emit_changes:
            raise ServerError("CreateQuery expects SELECT ... EMIT CHANGES")
        query_id = request.id or f"q{gen_unique()}"
        sink_name = query_id
        # request.id is user-supplied and becomes the sink STREAM name
        _reject_virtual_name("stream", sink_name)
        self.ctx.streams.create_stream(sink_name,
                                       stream_type=StreamType.TEMP)
        info = self._launch_query(plan, request.query_text, QUERY_PUSH,
                                  sink_stream=sink_name,
                                  sink_type=StreamType.TEMP,
                                  query_id=query_id)
        return self._query_pb(info)

    @unary
    def ListQueries(self, request, context):
        out = pb.ListQueriesResponse()
        for info in self.ctx.persistence.get_queries():
            if info.query_type == QUERY_VIEW:
                continue
            out.queries.append(self._query_pb(info))
        return out

    @unary
    def GetQuery(self, request, context):
        return self._query_pb(self.ctx.persistence.get_query(request.id))

    @unary
    def TerminateQueries(self, request, context):
        ids = ([q.query_id for q in self.ctx.persistence.get_queries()
                if q.query_type != QUERY_VIEW]
               if request.all else list(request.query_ids))
        done = []
        for qid in ids:
            try:
                self._terminate_query(qid)
                done.append(qid)
            except QueryNotFound:
                if not request.all:
                    raise
        return pb.TerminateQueriesResponse(query_ids=done)

    @unary
    def DeleteQuery(self, request, context):
        info = self.ctx.persistence.get_query(request.id)
        self._terminate_query(request.id)
        self.ctx.persistence.remove_query(request.id)
        self._remove_query_state(request.id)
        if info.query_type == QUERY_PUSH and info.sink:
            try:
                self.ctx.streams.delete_stream(info.sink, StreamType.TEMP)
            except StreamNotFound:
                pass
        return empty_pb2.Empty()

    @unary
    def RestartQuery(self, request, context):
        """The reference leaves this unimplemented
        (Handler/Query.hs:152-160); here a terminated query resumes from
        its snapshotted operator state + paired read checkpoints."""
        ctx = self.ctx
        info = ctx.persistence.get_query(request.id)
        sup = getattr(ctx, "supervisor", None)
        if sup is not None:
            # operator intent overrides the crash-loop verdict: close
            # the breaker and forget the death history. cancel (not
            # reset) so an executing supervised restart is waited out
            # first — otherwise both could pass the running check and
            # double-start the query
            sup.cancel(request.id)
        if request.id in ctx.running_queries:
            raise ServerError(f"query {request.id} is already running")
        self._resume_query(info)
        ctx.persistence.set_query_status(info.query_id, TaskStatus.RUNNING)
        try:
            ctx.events.append(
                "query_restarted",
                f"query {info.query_id} restarted by operator",
                query=info.query_id,
                request_id=current_request_id() or None)
        except Exception:  # noqa: BLE001 — journaling is best-effort
            pass
        return empty_pb2.Empty()

    def _resume_query(self, info: QueryInfo) -> None:
        ctx = self.ctx
        plan = stream_codegen(info.sql)
        if info.query_type == QUERY_VIEW:
            self._start_view_task(info, plan)
        else:
            stype = (StreamType.TEMP if info.query_type == QUERY_PUSH
                     else StreamType.STREAM)
            sink = stream_sink(ctx, info.sink, stype)
            task = QueryTask(ctx, info, plan
                             if isinstance(plan, plans.SelectPlan)
                             else plan.select, sink)
            ctx.running_queries[info.query_id] = task
            task.start()

    def resume_persisted(self) -> None:
        """Boot-time resume: relaunch every query that was RUNNING when
        the server last stopped (the reference resumes query definitions
        from ZK metadata, Persistence.hs:197-256; here operator state
        resumes too via the snapshot blobs)."""
        ctx = self.ctx
        for info in ctx.persistence.get_queries():
            if info.status not in (TaskStatus.RUNNING, TaskStatus.CREATED):
                continue
            if info.query_id in ctx.running_queries:
                continue
            # scheduler seed (SURVEY §2.3 task distribution): only
            # adopt queries whose recorded owner is gone — its boot
            # epoch predates ours; the claim is a CAS, so two racing
            # successors cannot both take one query. Adoption is
            # background work: under overload shedding it defers (the
            # records stay claimable for a later, healthier boot).
            if not scheduler.adoption_allowed(ctx, info.query_id):
                continue
            # armed placer: respect a LIVE peer's heartbeat lease even
            # at boot — a restarting node must not snatch back queries
            # a survivor adopted and is actively heartbeating (its
            # higher boot epoch would win the pure-epoch rule below)
            if ctx.placer.armed:
                rec = scheduler.assignment(ctx, info.query_id)
                if (rec is not None
                        and rec.get("node") != scheduler.node_name(ctx)
                        and scheduler.owner_live(
                            rec, ctx.heartbeat_lease_ms)):
                    continue
            if not scheduler.try_adopt(ctx, info.query_id):
                continue
            try:
                self._resume_query(info)
            except Exception:  # noqa: BLE001 — one bad query must not
                # block boot; its status records the failure
                log.exception("resume of query %s failed", info.query_id)
                try:
                    ctx.persistence.set_query_status(
                        info.query_id, TaskStatus.CONNECTION_ABORT)
                except Exception:
                    pass

    # ---- subscriptions ------------------------------------------------------

    @unary
    def CreateSubscription(self, request, context):
        if not self.ctx.streams.stream_exists(request.stream_name):
            raise StreamNotFound(request.stream_name)
        self.ctx.subscriptions.create(self.ctx, request)
        return request

    @unary
    def Subscribe(self, request, context):
        self.ctx.subscriptions.get(request.subscription_id)
        return pb.SubscribeResponse(
            subscription_id=request.subscription_id)

    @unary
    def ListSubscriptions(self, request, context):
        out = pb.ListSubscriptionsResponse()
        for rt in self.ctx.subscriptions.list():
            out.subscription.append(rt.meta)
        return out

    @unary
    def CheckSubscriptionExist(self, request, context):
        return pb.CheckSubscriptionExistResponse(
            exists=self.ctx.subscriptions.exists(request.subscription_id))

    @unary
    def DeleteSubscription(self, request, context):
        self.ctx.subscriptions.remove(request.subscription_id)
        self.ctx.ckp_store.remove(
            f"subscription-{request.subscription_id}")
        return empty_pb2.Empty()

    @unary
    def SendConsumerHeartbeat(self, request, context):
        # liveness no-op, like the reference (Handler.hs:610-617)
        return pb.ConsumerHeartbeatResponse(
            subscription_id=request.subscription_id)

    @unary
    def Fetch(self, request, context):
        rt = self.ctx.subscriptions.get(request.subscription_id)
        flow = self.ctx.flow
        if flow.active:
            # read quota: gate the call, charge the actual count after
            # (debt-based — sustained rate converges on the quota)
            flow.admit_read(rt.meta.stream_name)
        got = rt.fetch(timeout_ms=int(request.timeout_ms),
                       max_size=int(request.max_size) or 256)
        if flow.active and got:
            flow.charge_read(rt.meta.stream_name, len(got))
        out = pb.FetchResponse()
        for rid, payload in got:
            out.received_records.append(pb.ReceivedRecord(
                record_id=pb.RecordId(batch_id=rid.lsn,
                                      batch_index=rid.idx),
                record=payload))
        # read accounting (note_read) moved into SubscriptionRuntime
        # .fetch so the streaming dispatcher's drains count too
        return out

    @unary
    def Acknowledge(self, request, context):
        rt = self.ctx.subscriptions.get(request.subscription_id)
        rt.ack([RecId(a.batch_id, a.batch_index) for a in request.ack_ids])
        return empty_pb2.Empty()

    @streaming
    def StreamingFetch(self, request_iterator, context):
        """BiDi fetch with consumer round-robin (Handler.hs:720-935):
        the first request registers the consumer, subsequent requests
        carry acks."""
        try:
            first = next(iter(request_iterator))
        except StopIteration:
            return
        rt = self.ctx.subscriptions.get(first.subscription_id)
        consumer = rt.register_consumer(first.consumer_name or "consumer")
        if first.ack_ids:
            rt.ack([RecId(a.batch_id, a.batch_index)
                    for a in first.ack_ids], consumer=consumer)

        def drain_acks():
            try:
                for req in request_iterator:
                    if req.ack_ids:
                        # acks refill this consumer's delivery credits
                        rt.ack([RecId(a.batch_id, a.batch_index)
                                for a in req.ack_ids], consumer=consumer)
            except Exception:
                pass
            finally:
                consumer.alive = False

        t = threading.Thread(target=drain_acks, daemon=True)
        t.start()
        inflight = None  # batch taken from the queue but not yet yielded
        try:
            import queue as _q

            while context.is_active() and consumer.alive:
                try:
                    inflight = consumer.queue.get(timeout=0.1)
                except _q.Empty:
                    continue
                resp = pb.StreamingFetchResponse()
                for rid, payload in inflight:
                    resp.received_records.append(pb.ReceivedRecord(
                        record_id=pb.RecordId(batch_id=rid.lsn,
                                              batch_index=rid.idx),
                        record=payload))
                yield resp
                inflight = None
        finally:
            # a batch obtained but not successfully yielded was noted in
            # the AckWindow — hand it back for redelivery, else the ack
            # lower bound stalls forever
            if inflight is not None:
                rt.requeue(inflight)
            rt.unregister_consumer(consumer)

    # ---- connectors ---------------------------------------------------------

    @unary
    def CreateSinkConnector(self, request, context):
        plan = stream_codegen(request.config)
        if not isinstance(plan, plans.CreateSinkConnectorPlan):
            raise ServerError(
                "config must be a CREATE SINK CONNECTOR statement")
        cid = request.id or plan.name
        info = self._create_connector(cid, request.config, plan)
        return self._connector_pb(info)

    @unary
    def ListConnectors(self, request, context):
        out = pb.ListConnectorsResponse()
        for info in self.ctx.persistence.get_connectors():
            out.connectors.append(self._connector_pb(info))
        return out

    @unary
    def GetConnector(self, request, context):
        return self._connector_pb(
            self.ctx.persistence.get_connector(request.id))

    @unary
    def DeleteConnector(self, request, context):
        self._terminate_connector(request.id)
        self.ctx.persistence.remove_connector(request.id)
        self.ctx.ckp_store.remove(f"connector-{request.id}")
        return empty_pb2.Empty()

    @unary
    def RestartConnector(self, request, context):
        ctx = self.ctx
        info = ctx.persistence.get_connector(request.id)
        if request.id in ctx.running_connectors:
            raise ServerError(f"connector {request.id} is already running")
        plan = stream_codegen(info.sql)
        self._start_connector_task(info, plan)
        return empty_pb2.Empty()

    @unary
    def TerminateConnector(self, request, context):
        self._terminate_connector(request.id)
        return empty_pb2.Empty()

    # ---- views --------------------------------------------------------------

    @unary
    def CreateView(self, request, context):
        plan = stream_codegen(request.sql)
        if not isinstance(plan, plans.CreateViewPlan):
            raise ServerError("sql must be CREATE VIEW ... AS SELECT ...")
        info = self._create_view(plan, request.sql)
        return self._view_pb(info)

    @unary
    def ListViews(self, request, context):
        out = pb.ListViewsResponse()
        for info in self.ctx.persistence.get_queries():
            if info.query_type == QUERY_VIEW:
                out.views.append(self._view_pb(info))
        return out

    @unary
    def GetView(self, request, context):
        info = self.ctx.persistence.get_query(f"view-{request.view_id}")
        return self._view_pb(info)

    @unary
    def DeleteView(self, request, context):
        self._drop_view(request.view_id)
        return empty_pb2.Empty()

    # ---- cluster ------------------------------------------------------------

    @unary
    def ListNodes(self, request, context):
        return pb.ListNodesResponse(nodes=[self._node_pb()])

    @unary
    def GetNode(self, request, context):
        if request.id != self.ctx.server_id:
            raise ServerError(f"unknown node {request.id}")
        return self._node_pb()

    @unary
    def GetQueryTrace(self, request, context):
        """Per-stage timing summary of a RUNNING query (decode /
        key_encode / step / emit / snapshot rings — SURVEY §5.1), plus
        the overlapped-ingest pipeline's stage occupancy when the query
        runs the staged columnar path."""
        task = self.ctx.running_queries.get(request.id)
        if task is None:
            raise QueryNotFound(request.id)
        out = task.tracer.summary()
        pipe = getattr(task, "_pipe", None)
        if pipe is not None:
            out["pipeline"] = pipe.stats()
        return rec.dict_to_struct(out)

    @unary
    def SendAdminCommand(self, request, context):
        """Store-ops verbs (reference hstore-admin trim/findTime/
        offsets + maintenance introspection, admin/app/cli.hs:56-69):
        one JSON-in/JSON-out RPC backing `python -m hstream_tpu_torch.admin`.
        """
        import json as _json

        ctx = self.ctx
        args = rec.struct_to_dict(request.args)
        cmd = request.command

        def stream_logid(name: str) -> int:
            return ctx.streams.get_logid(name)

        if cmd == "trim":
            logid = stream_logid(args["stream"])
            ctx.store.trim(logid, int(args["lsn"]))
            out = {"stream": args["stream"],
                   "trim_point": ctx.store.trim_point(logid)}
        elif cmd == "find-time":
            logid = stream_logid(args["stream"])
            out = {"stream": args["stream"],
                   "lsn": ctx.store.find_time(logid,
                                              int(args["ts_ms"]))}
        elif cmd == "offsets":
            logid = stream_logid(args["stream"])
            out = {"stream": args["stream"], "logid": logid,
                   "trim_point": ctx.store.trim_point(logid),
                   "tail_lsn": ctx.store.tail_lsn(logid),
                   "is_empty": ctx.store.is_log_empty(logid)}
        elif cmd == "sub-lag":
            rt = ctx.subscriptions.get(args["subscription"])
            tail = ctx.store.tail_lsn(rt.logid)
            committed = rt.committed_lsn
            out = {"subscription": args["subscription"],
                   "stream": rt.meta.stream_name,
                   "committed_lsn": committed, "tail_lsn": tail,
                   "lag": max(0, tail - committed)}
        elif cmd == "snapshots":
            out = {}
            for key in ctx.store.meta_list("qsnap/"):
                name = key[len("qsnap/"):]
                if "@" in name:
                    continue  # rotation slots surface via their pointer
                blob = ctx.store.meta_get(key)
                entry = {"bytes": 0 if blob is None else len(blob)}
                slot = (None if blob is None
                        else parse_snapshot_pointer(blob))
                if slot is not None:
                    # two-slot rotation: report the pointed-at blob,
                    # not the ~20-byte pointer an operator would
                    # mistake for the state size
                    sb = ctx.store.meta_get(snapshot_slot_key(name, slot))
                    entry = {"bytes": 0 if sb is None else len(sb),
                             "slot": slot}
                out[name] = entry
        elif cmd == "replicas":
            status = getattr(ctx.store, "follower_status", None)
            out = {"role": "leader" if status else "single",
                   "followers": status() if status else []}
            leader = getattr(ctx.store, "leader_status", None)
            if leader is not None:
                # epoch/fencing/dedup state: one verb answers
                # "who leads, at what epoch, is anyone fenced"
                out["leader"] = leader()
        elif cmd == "promote":
            # epoch-fenced failover. Two shapes:
            #   promote target=ADDR        planned handoff — THIS
            #     leader raises the target's epoch and fences itself
            #   promote replicas=A,B,...   leader-death path — pick the
            #     most-caught-up reachable replica (highest
            #     (epoch, applied_seq, node_id)) and promote it
            # the replica group (store/replica) waits for ROADMAP A5c
            target = args.get("target") or None
            addrs = [a.strip()
                     for a in str(args.get("replicas") or "").split(",")
                     if a.strip()]
            hint = args.get("leader_addr") or None
            if target:
                promote = getattr(ctx.store, "promote_follower", None)
                if promote is None:
                    raise ServerError(
                        "this server's store is not a replication "
                        "leader; use promote replicas=A,B,... against "
                        "the replica group directly")
                out = promote(target, leader_addr=hint)
            elif addrs:
                raise NotPortedError(
                    "promoting a store replica (promote replicas=)",
                    "A5c")
            else:
                raise ServerError(
                    "promote needs target=ADDR or replicas=A,B,...")
            if out.get("ok"):
                ctx.stats.stream_stat_add("promotions", "_store")
        elif cmd == "assignments":
            out = scheduler.assignments(ctx)
        elif cmd == "placer":
            # placements, per-node scores, last decision + machine-
            # readable reason
            out = ctx.placer.status()
        elif cmd == "quota-set":
            from hstream_tpu_torch.flow import Quota

            scope = args.pop("scope")
            try:
                q = ctx.flow.set_quota(scope, Quota.from_json(args))
            except ValueError as e:
                raise ServerError(str(e)) from e
            out = {"scope": scope, **q.to_json()}
        elif cmd == "quota-get":
            q = ctx.flow.get_quota(args["scope"])
            out = {"scope": args["scope"],
                   **({"unset": True} if q is None else q.to_json())}
        elif cmd == "quota-unset":
            try:
                ctx.flow.unset_quota(args["scope"])
            except ValueError as e:
                raise ServerError(str(e)) from e
            out = {"scope": args["scope"], "unset": True}
        elif cmd == "quota-list":
            out = {scope: q.to_json()
                   for scope, q in ctx.flow.list_quotas().items()}
        elif cmd == "flow-status":
            out = ctx.flow.status()
        elif cmd == "read-cache":
            # read plane: snapshot/expansion cache counters
            cache = getattr(ctx, "read_cache", None)
            out = ({"enabled": False} if cache is None
                   else {"enabled": True,
                         "max_bytes": cache.max_bytes,
                         "max_staleness_ms": cache.max_staleness_ms,
                         **cache.stats()})
        elif cmd == "fault-set":
            try:
                ctx.faults.arm(str(args["site"]), str(args["spec"]))
            except (KeyError, ValueError) as e:
                raise ServerError(f"bad fault spec: {e}") from e
            out = {"site": args["site"], "spec": args["spec"],
                   "armed": True}
        elif cmd == "fault-clear":
            site = args.get("site") or None
            ctx.faults.disarm(site)
            out = {"cleared": site or "all"}
        elif cmd == "fault-list":
            out = {"active": ctx.faults.active,
                   "sites": ctx.faults.status()}
        elif cmd == "supervisor":
            sup = getattr(ctx, "supervisor", None)
            out = sup.status() if sup is not None else {}
        elif cmd == "events":
            out = {"events": ctx.events.query(
                kind=args.get("kind") or None,
                since=int(args.get("since", 0)),
                limit=int(args.get("limit", 100)))}
        elif cmd == "metrics":
            # full Prometheus exposition as text — the gateway /metrics
            # route and curl-through-admin both unwrap {"text": ...}
            from hstream_tpu_torch.stats.prometheus import render_metrics

            out = {"text": render_metrics(ctx)}
        elif cmd == "health":
            # per-query health rollup: OK/DEGRADED/STALLED
            # with reasons — GET /queries/<id>/health and `admin
            # health` both land here
            from hstream_tpu_torch.server import health as _health

            q = args.get("query") or None
            if q:
                out = _health.evaluate_query(ctx, str(q))
            else:
                out = _health.evaluate_all(ctx)  # qid -> health dict
        elif cmd == "locks":
            # lock-order witness ledger: armed state,
            # per-lock acquire/contention counts + wait/hold p50/p99
            # (from the bound histograms), the observed order graph,
            # and any detected cycles. arm/disarm flips the witness
            # at runtime like fault-set does for the chaos registry.
            lt = getattr(ctx, "locktrace", None)
            if lt is None:
                from hstream_tpu_torch.common.locktrace import LOCKTRACE as lt
            action = str(args.get("action") or "")
            if action == "arm":
                lt.arm()
            elif action == "disarm":
                lt.disarm()
            elif action:
                raise ServerError(
                    f"unknown locks action {action!r} (arm/disarm)")
            out = lt.status()
        elif cmd == "stats":
            # declarative-family rate tables: one entity
            # scope per call (streams | subscriptions | queries), every
            # family's rate at the requested ladder interval plus the
            # all-time total — the `hadmin server stats` analogue
            # behind `admin stats` and the gateway's GET /stats
            from hstream_tpu_torch.stats.families import families_for_scope
            from hstream_tpu_torch.stats.timeseries import INTERVAL_NAMES

            entity = str(args.get("entity") or "streams")
            scope = {"streams": "stream", "stream": "stream",
                     "subscriptions": "subscription",
                     "subscription": "subscription",
                     "queries": "query", "query": "query"}.get(entity)
            if scope is None:
                raise ServerError(
                    f"unknown stats entity {entity!r} "
                    f"(streams|subscriptions|queries)")
            interval = str(args.get("interval") or "1min")
            if interval not in INTERVAL_NAMES:
                raise ServerError(
                    f"unknown interval {interval!r} "
                    f"(one of {'|'.join(INTERVAL_NAMES)})")
            try:
                fams = families_for_scope(scope)
            except KeyError as e:
                raise ServerError(str(e)) from e
            out = {}
            keys = {k for f in fams for k in ctx.stats.stat_keys(f.name)}
            # every scope reports its LIVE topology (GetStats
            # discipline): a deleted entity's residual ladder — still
            # present until the next scrape-time stat_drop_stale sweep
            # — must not resurface through the admin table. "live" is
            # the one shared definition (cluster.live_entity_keys);
            # only the reserved overflow fold bypasses it.
            from hstream_tpu_torch.stats import TS_OVERFLOW_LABEL
            from hstream_tpu_torch.stats.cluster import live_entity_keys

            live = live_entity_keys(ctx, scope)
            keys = {k for k in keys
                    if k in live or k == TS_OVERFLOW_LABEL}
            for key in sorted(keys):
                row = {"interval": interval}
                for f in fams:
                    lad = ctx.stats.stat_ladder(f.name, key)
                    row[f"{f.name}_per_s"] = round(lad[interval], 3)
                    row[f"{f.name}_total"] = lad["total"]
                out[key] = row
        elif cmd == "cluster-stats":
            # federation: fan the ClusterStats RPC out to
            # explicit peers (or this leader's followers) and return
            # every node's report keyed by node name — `admin
            # cluster-stats` renders the merged per-node table from it
            from hstream_tpu_torch.stats import cluster as _cluster

            peers = [a.strip()
                     for a in str(args.get("peers") or "").split(",")
                     if a.strip()]
            timeout = float(args.get("timeout_s") or 5.0)
            reports = _cluster.collect_cluster(ctx, peers,
                                               timeout=timeout)
            # keyed by node name, disambiguated on collision (two
            # bare followers booted with the default node id must
            # BOTH stay visible in the merged table, never silently
            # last-writer-wins)
            out = {}
            for i, r in enumerate(reports):
                key = r.get("node") or r.get("addr") or f"node-{i}"
                if key in out:
                    key = f"{key} [{r.get('addr') or i}]"
                while key in out:
                    key = f"{key}+"
                out[key] = r
        elif cmd == "programs":
            # compiled-program inventory: one row per compile of
            # the port (common.tracing.note_compile: the kernel
            # library's build, a program-factory miss)
            # (`admin programs`, GET /programs)
            from hstream_tpu_torch.stats.devicecost import PROGRAMS

            out = {"summary": PROGRAMS.summary(),
                   "programs": PROGRAMS.rows()}
        elif cmd == "flightrec":
            # flight-recorder bundles: the postmortem black
            # box for a distressed query (`admin flightrec <id>`,
            # GET /queries/<id>/flightrec); no query id -> the index
            flightrec = getattr(ctx, "flightrec", None)
            qid = str(args.get("query") or "")
            if flightrec is None:
                raise ServerError("flight recorder unavailable")
            if not qid:
                out = flightrec.summary()
            else:
                bundles = flightrec.bundles(qid)
                if not bundles:
                    raise ServerError(
                        f"no flight-recorder bundles for query {qid!r}")
                out = {"query": qid, "bundles": bundles}
        elif cmd == "trace-spans":
            # one scope's span ring as Chrome trace-event JSON
            # (GET /queries/<id>/trace, `admin trace --spans`)
            scope = str(args.get("scope") or "")
            if not scope:
                raise ServerError(
                    "trace-spans needs scope=<query id | stream | "
                    "subscription>")
            out = ctx.tracing.export_chrome(scope)
            out["scope"] = scope
            out["sample_rate"] = ctx.tracing.sample_rate
        else:
            raise ServerError(f"unknown admin command {cmd!r}")
        return pb.AdminCommandResponse(result=_json.dumps(out))

    @unary
    def GetStats(self, request, context):
        """Expose the stats holder (counters + time-series rates) — the
        observability the reference keeps native-only
        (common/clib/stats.h)."""
        from hstream_tpu_torch.stats import (
            PER_STREAM_COUNTERS,
            PER_STREAM_TIME_SERIES,
        )

        stats = self.ctx.stats
        # counters are never pruned; report only streams that still
        # exist so dashboards see the live topology
        live = set(self.ctx.streams.find_streams())
        per_stream: dict[str, pb.StreamStats] = {}

        def ent(stream: str) -> pb.StreamStats:
            e = per_stream.get(stream)
            if e is None:
                e = pb.StreamStats(stream_name=stream)
                per_stream[stream] = e
            return e

        for metric in PER_STREAM_COUNTERS:
            for stream, v in stats.stream_stat_getall(metric).items():
                if stream in live:
                    ent(stream).counters[metric] = v
        for metric, _levels in PER_STREAM_TIME_SERIES:
            for stream in list(per_stream):
                ent(stream).rates[metric] = stats.time_series_peek_rate(
                    metric, stream)
        out = pb.GetStatsResponse()
        for name in sorted(per_stream):
            out.stats.append(per_stream[name])
        return out

    @unary
    def ClusterStats(self, request, context):
        """This node's load report: per-stream rate
        ladders, per-query health, append-front depth, rss — one fold
        of the stats holder, no device work. The federation fan-out
        (admin cluster-stats / stats.cluster.collect_cluster) calls
        this on every peer and merges."""
        from hstream_tpu_torch.stats import cluster as _cluster

        return pb.ClusterStatsResponse(reports=[
            _cluster.report_to_pb(_cluster.node_report(self.ctx))])

    # ---- plan execution (executeQueryHandler dispatch) ----------------------

    def _execute_plan(self, plan, sql: str,
                      producer: tuple[str, int] | None = None
                      ) -> list[dict[str, Any]]:
        ctx = self.ctx
        if isinstance(plan, plans.CreatePlan):
            _reject_virtual_name("stream", plan.stream)
            ctx.streams.create_stream(plan.stream)
            return [{"stream": plan.stream, "created": True}]
        if isinstance(plan, plans.CreateBySelectPlan):
            _reject_virtual_name("stream", plan.stream)
            ctx.streams.create_stream(plan.stream)
            info = self._launch_query(plan.select, sql, QUERY_STREAM,
                                      sink_stream=plan.stream)
            return [{"stream": plan.stream, "query": info.query_id}]
        if isinstance(plan, plans.CreateViewPlan):
            info = self._create_view(plan, sql)
            return [{"view": plan.view, "query": info.query_id}]
        if isinstance(plan, plans.CreateSinkConnectorPlan):
            info = self._create_connector(plan.name, sql, plan)
            return [{"connector": info.connector_id}]
        if isinstance(plan, plans.InsertPlan):
            logid = ctx.streams.get_logid(plan.stream)
            if plan.payload is not None:
                record = rec.build_record(plan.payload)
            else:
                record = rec.build_record(plan.raw_payload or b"")
            data = record.SerializeToString()
            if ctx.flow.active:  # SQL INSERT is an ingress path too
                ctx.flow.admit_append(plan.stream, 1, len(data))
            try:
                if producer is not None:
                    # stamped INSERT: same exactly-once contract as a
                    # stamped Append (retry across failover dedups)
                    lsn, _n, dup = _dedup_append(
                        ctx, logid, [data], Compression.NONE,
                        producer[0], producer[1])
                else:
                    lsn, dup = ctx.store.append(logid, data), False
            except Exception:
                ctx.stats.stream_stat_add("append_failed", plan.stream)
                raise
            if dup:
                ctx.stats.stream_stat_add("append_deduped", plan.stream)
                return [{"stream": plan.stream, "lsn": lsn,
                         "duplicate": True}]
            ctx.stats.note_append(plan.stream, 1, len(data))
            return [{"stream": plan.stream, "lsn": lsn}]
        if isinstance(plan, plans.ShowPlan):
            return self._show(plan.what)
        if isinstance(plan, plans.DropPlan):
            return self._drop(plan)
        if isinstance(plan, plans.TerminatePlan):
            if plan.query_id is None:
                ids = [q.query_id for q in ctx.persistence.get_queries()
                       if q.query_type != QUERY_VIEW]
            else:
                ids = [plan.query_id]
            for qid in ids:
                self._terminate_query(qid)
            return [{"terminated": qid} for qid in ids]
        if isinstance(plan, plans.ExplainPlan):
            return [{"explain": plan.text}]
        if isinstance(plan, plans.SelectViewPlan):
            # a pre-existing user view of a reserved name (created
            # before the collision guard) keeps winning the route —
            # rejecting creation must not orphan restored state
            if plan.view in VIRTUAL_TABLES \
                    and plan.view not in ctx.views.names():
                return self._select_virtual(plan)
            mat = ctx.views.get(plan.view)
            return self._serve_view(plan.view, mat, plan.select, sql)
        if isinstance(plan, plans.SelectPlan):
            raise ServerError(
                "push queries (EMIT CHANGES) go through ExecutePushQuery")
        raise ServerError(f"cannot execute {type(plan).__name__}")

    def _serve_view(self, name: str, mat, select, sql: str
                    ) -> list[dict[str, Any]]:
        """Pull-query serve through the read plane: the
        snapshot cache collapses N concurrent readers onto ONE executor
        extract per close cycle; `read_out_records` / `read_extracts`
        carry the serve rates per view."""
        ctx = self.ctx
        cache = getattr(ctx, "read_cache", None)
        if cache is None:
            return serve_select_view(mat, select)
        rows, _how, extracted = cache.serve_view(name, mat, select, sql)
        try:
            ctx.stats.stat_add("read_out_records", name, float(len(rows)))
            if extracted:
                ctx.stats.stream_stat_add("read_extracts", name)
        except Exception:  # noqa: BLE001 — metrics must not fail reads
            pass
        return rows

    def _select_virtual(self, plan) -> list[dict[str, Any]]:
        """LDQuery-lite (reference hs_ldquery.cpp:1-175): plain SQL —
        WHERE + projections — over internal metadata tables exposed as
        __streams__/__queries__/__subscriptions__/__views__/
        __connectors__/__stats__. Same AST evaluation the view pull
        path applies (views.serve_select_view), minus window slicing."""
        from hstream_tpu_torch.server.views import filter_rows, project_rows

        select = plan.select
        rows = filter_rows(self._virtual_rows(plan.view), select)
        return project_rows(rows, select)

    def _virtual_rows(self, table: str) -> list[dict[str, Any]]:
        ctx = self.ctx
        if table == "__streams__":
            out = []
            for name in ctx.streams.find_streams():
                meta = ctx.streams.stream_meta(name)
                logid = ctx.streams.get_logid(name)
                out.append({
                    "name": name, "logid": logid,
                    "replication_factor":
                        meta.get("replication_factor", 1),
                    "tail_lsn": ctx.store.tail_lsn(logid),
                    "trim_point": ctx.store.trim_point(logid)})
            return out
        if table == "__queries__":
            return [{"id": q.query_id,
                     "status": getattr(q.status, "name", str(q.status)),
                     "type": q.query_type, "sink": q.sink,
                     "created_ms": q.created_time_ms, "sql": q.sql}
                    for q in ctx.persistence.get_queries()]
        if table == "__subscriptions__":
            out = []
            for rt in ctx.subscriptions.list():
                tail = ctx.store.tail_lsn(rt.logid)
                out.append({"id": rt.sub_id,
                            "stream": rt.meta.stream_name,
                            "committed_lsn": rt.committed_lsn,
                            "tail_lsn": tail,
                            "lag": max(0, tail - rt.committed_lsn)})
            return out
        if table == "__views__":
            return [{"name": n} for n in ctx.views.names()]
        if table == "__connectors__":
            return [{"id": c.connector_id,
                     "status": getattr(c.status, "name", str(c.status)),
                     "sql": c.sql}
                    for c in ctx.persistence.get_connectors()]
        if table == "__stats__":
            from hstream_tpu_torch.stats import (
                PER_STREAM_COUNTERS,
                PER_STREAM_TIME_SERIES,
            )

            live = set(ctx.streams.find_streams())
            rows: dict[str, dict[str, Any]] = {}
            for metric in PER_STREAM_COUNTERS:
                for s, v in ctx.stats.stream_stat_getall(metric).items():
                    if s in live:
                        rows.setdefault(s, {"stream": s})[metric] = v
            for metric, _levels in PER_STREAM_TIME_SERIES:
                for s in rows:
                    rows[s][f"{metric}_rate"] = \
                        ctx.stats.time_series_peek_rate(metric, s)
            return [rows[s] for s in sorted(rows)]
        raise ServerError(f"unknown virtual table {table}")

    def _show(self, what: str) -> list[dict[str, Any]]:
        ctx = self.ctx
        if what == "STREAMS":
            return [{"stream": n} for n in ctx.streams.find_streams()]
        if what == "VIEWS":
            return [{"view": n} for n in ctx.views.names()]
        if what == "QUERIES":
            return [{"id": q.query_id, "status": q.status, "sql": q.sql}
                    for q in ctx.persistence.get_queries()
                    if q.query_type != QUERY_VIEW]
        if what == "CONNECTORS":
            return [{"id": c.connector_id, "status": c.status}
                    for c in ctx.persistence.get_connectors()]
        raise ServerError(f"SHOW {what} unsupported")

    def _drop(self, plan: plans.DropPlan) -> list[dict[str, Any]]:
        ctx = self.ctx
        try:
            if plan.what == "STREAM":
                ctx.streams.delete_stream(plan.name)
            elif plan.what == "VIEW":
                self._drop_view(plan.name)
            elif plan.what == "CONNECTOR":
                self._terminate_connector(plan.name)
                ctx.persistence.remove_connector(plan.name)
            else:
                raise ServerError(f"DROP {plan.what} unsupported")
        except HStreamError:
            if not plan.if_exists:
                raise
        return [{"dropped": plan.name}]

    # ---- task helpers -------------------------------------------------------

    def _check_columns_against_stream(self,
                                      plan: plans.SelectPlan) -> None:
        """Unknown-column validation against SAMPLED records: the
        reference's Validate.hs cannot see data, so an unknown column
        silently becomes NULL and aggregates run on garbage; here query
        creation reads the source stream's tail and rejects references
        to columns absent from every sampled record. An empty stream
        skips the check (nothing to know yet)."""
        if plan.join is not None:
            return  # two sources with qualified refs; not sampled
        from hstream_tpu_torch.engine.plan import AggregateNode
        from hstream_tpu_torch.store.api import LSN_INVALID

        ctx = self.ctx
        referenced = set(plan.schema_req.inferred)
        if isinstance(plan.node, AggregateNode):
            from hstream_tpu_torch.engine.expr import Col as _Col

            referenced |= {g.name for g in plan.node.group_keys
                           if isinstance(g, _Col)}
        if not referenced:
            return
        try:
            logid = ctx.streams.get_logid(plan.source)
            tail = ctx.store.tail_lsn(logid)
        except HStreamError:
            return
        if tail == LSN_INVALID:
            return
        # best-effort sample: head + tail batches, so heterogeneous
        # streams (different record shapes interleaved) are less likely
        # to spuriously miss a real column; a column absent from EVERY
        # sampled record is still rejected — better a creation-time
        # error than aggregates silently running on NULLs
        reader = ctx.store.new_reader()
        reader.set_timeout(0)
        lo = ctx.store.trim_point(logid) + 1
        reader.start_reading(logid, lo, min(lo + 2, tail))
        head = reader.read(16)
        reader.stop_reading(logid)
        reader.start_reading(logid, max(tail - 4, lo), tail)
        fields: set[str] = set()

        def collect(item) -> bool:
            """Union item's record fields into `fields`; True if any
            record was decodable (one shared walk for the sample pass
            and the widen pass)."""
            any_dec = False
            if not isinstance(item, DataBatch):
                return False
            for payload in item.payloads:
                r = rec.parse_record(payload)
                if (r.header.flag == rec.pb.RECORD_FLAG_RAW
                        and columnar.is_columnar(r.payload)):
                    try:
                        _, cols = columnar.decode_columnar(r.payload)
                    except Exception:  # noqa: BLE001
                        continue
                    fields.update(cols)
                    any_dec = True
                else:
                    d = rec.record_to_dict(r)
                    if d is not None:
                        fields.update(d)
                        any_dec = True
            return any_dec

        sampled = False
        for item in head + reader.read(64):
            sampled |= collect(item)
        missing = referenced - fields
        if sampled and missing:
            # widen before rejecting: a heterogeneous stream may carry
            # the column only in batches outside the head/tail sample
            reader.stop_reading(logid)
            reader.start_reading(logid, lo, tail)
            for item in reader.read(512):
                collect(item)
                missing = referenced - fields
                if not missing:
                    break
        if sampled and missing:
            raise ServerError(
                f"unknown column(s) {sorted(missing)}: not present in "
                f"recent records of stream {plan.source!r}")

    def _launch_query(self, plan: plans.SelectPlan, sql: str, qtype: str,
                      *, sink_stream: str,
                      sink_type: StreamType = StreamType.STREAM,
                      query_id: str | None = None) -> QueryInfo:
        ctx = self.ctx
        self._check_columns_against_stream(plan)
        query_id = query_id or f"q{gen_unique()}"
        info = QueryInfo(query_id=query_id, sql=sql,
                         created_time_ms=now_ms(), query_type=qtype,
                         status=TaskStatus.CREATED, sink=sink_stream)
        ctx.persistence.insert_query(info)
        # co-compile packing: with --pack-queries, a query
        # whose (source, window, agg-set) signature matches an existing
        # pack joins that group's shared slot-keyed executor — one
        # dispatch for all members, nothing compiled for the 2nd..Nth
        pool = getattr(ctx, "pack_pool", None)
        if pool is not None:
            from hstream_tpu_torch.placer.packing import PackRefusal

            member = pool.try_attach(
                query_id, plan, stream_sink(ctx, sink_stream, sink_type))
            if not isinstance(member, PackRefusal):
                scheduler.record_assignment(ctx, query_id)
                ctx.running_queries[query_id] = member
                ctx.persistence.set_query_status(
                    query_id, TaskStatus.RUNNING)
                return info
        # placement: an armed placer ranks every node's
        # published load record; when a less-loaded peer wins, this
        # node writes an OFFERED scheduler record instead of launching
        # — the target's adoption sweep claims and resumes it there
        if qtype == QUERY_STREAM:
            target = ctx.placer.place_for_launch(query_id)
            if target is not None:
                return info
        scheduler.record_assignment(ctx, query_id)
        task = QueryTask(ctx, info, plan,
                         stream_sink(ctx, sink_stream, sink_type))
        # correlation: the creating request's id rides the tracer so
        # `admin trace` ties a running query back to who launched it;
        # a SAMPLED creating request additionally binds the task's
        # stage timings into its trace
        task.tracer.request_id = current_request_id() or None
        self._bind_task_trace(task, query_id)
        ctx.running_queries[query_id] = task
        task.start()
        return info

    def _remove_query_state(self, query_id: str) -> None:
        """Durable per-query state cleanup: operator-state snapshot
        (pointer + both rotation slots) + read checkpoints."""
        self.ctx.store.meta_delete(snapshot_key(query_id))
        for slot in (0, 1):
            self.ctx.store.meta_delete(
                snapshot_slot_key(query_id, slot))
        self.ctx.ckp_store.remove(f"query-{query_id}")

    def _terminate_query(self, query_id: str) -> None:
        ctx = self.ctx
        ctx.persistence.get_query(query_id)  # raises if unknown
        sup = getattr(ctx, "supervisor", None)
        if sup is not None:
            # an in-flight supervised restart must not resurrect a
            # query the operator is terminating
            sup.cancel(query_id)
        task = ctx.running_queries.pop(query_id, None)
        if task is not None:
            task.stop()
        ctx.persistence.set_query_status(query_id, TaskStatus.TERMINATED)
        scheduler.drop_assignment(ctx, query_id)

    def _create_view(self, plan: plans.CreateViewPlan,
                     sql: str) -> QueryInfo:
        ctx = self.ctx
        _reject_virtual_name("view", plan.view)
        self._check_columns_against_stream(plan.select)
        query_id = f"view-{plan.view}"
        info = QueryInfo(query_id=query_id, sql=sql,
                         created_time_ms=now_ms(), query_type=QUERY_VIEW,
                         status=TaskStatus.CREATED, sink=plan.view)
        ctx.persistence.insert_query(info)
        scheduler.record_assignment(ctx, query_id)
        self._start_view_task(info, plan)
        return info

    def _start_view_task(self, info: QueryInfo, plan) -> None:
        ctx = self.ctx
        select = plan.select if isinstance(plan, plans.CreateViewPlan) \
            else plan
        from hstream_tpu_torch.engine.plan import AggregateNode
        from hstream_tpu_torch.sql.codegen import emitted_group_cols

        group_cols = None
        if isinstance(select.node, AggregateNode):
            group_cols = emitted_group_cols(select.node)
        mat = Materialization(group_cols=group_cols)
        task = QueryTask(ctx, info, select, mat.add_closed)
        task.sink_dump = mat.dump
        task.sink_load = mat.load
        mat.task = task
        self._bind_task_trace(task, info.query_id)
        ctx.views.register(info.sink, mat)
        ctx.running_queries[info.query_id] = task
        task.start()

    def _drop_view(self, view: str) -> None:
        ctx = self.ctx
        ctx.views.get(view)  # raises if unknown
        query_id = f"view-{view}"
        task = ctx.running_queries.pop(query_id, None)
        if task is not None:
            task.stop()
        ctx.views.remove(view)
        cache = getattr(ctx, "read_cache", None)
        if cache is not None:
            cache.invalidate_view(view)
        try:
            ctx.persistence.remove_query(query_id)
        except QueryNotFound:
            pass
        self._remove_query_state(query_id)
        scheduler.drop_assignment(ctx, query_id)

    def _create_connector(self, cid: str, sql: str,
                          plan: plans.CreateSinkConnectorPlan
                          ) -> ConnectorInfo:
        ctx = self.ctx
        if plan.if_not_exist:
            try:
                return ctx.persistence.get_connector(cid)
            except HStreamError:
                pass
        # refused before anything is persisted: no connector record is
        # left behind for a boot to resume
        _connectors_not_ported()
        info = ConnectorInfo(connector_id=cid, sql=sql,
                             created_time_ms=now_ms(),
                             status=TaskStatus.CREATED)
        ctx.persistence.insert_connector(info)
        self._start_connector_task(info, plan)
        return info

    def _start_connector_task(self, info: ConnectorInfo, plan) -> None:
        # the reference builds a ConnectorTask over connectors.make_sink
        # here; the connectors wait for ROADMAP A5c
        _connectors_not_ported()

    def _terminate_connector(self, cid: str) -> None:
        ctx = self.ctx
        ctx.persistence.get_connector(cid)
        task = ctx.running_connectors.pop(cid, None)
        if task is not None:
            task.stop()
        ctx.persistence.set_connector_status(cid, TaskStatus.TERMINATED)

    # ---- pb builders --------------------------------------------------------

    def _query_pb(self, info: QueryInfo) -> pb.Query:
        return pb.Query(id=info.query_id, status=info.status,
                        created_time_ms=info.created_time_ms,
                        query_text=info.sql)

    def _connector_pb(self, info: ConnectorInfo) -> pb.Connector:
        return pb.Connector(id=info.connector_id, status=info.status,
                            created_time_ms=info.created_time_ms,
                            config=info.sql)

    def _view_pb(self, info: QueryInfo) -> pb.View:
        return pb.View(view_id=info.sink, status=info.status,
                       created_time_ms=info.created_time_ms, sql=info.sql)

    def _node_pb(self) -> pb.Node:
        ctx = self.ctx
        return pb.Node(id=ctx.server_id, address=ctx.host, port=ctx.port,
                       roles=["server"], status="Running")
