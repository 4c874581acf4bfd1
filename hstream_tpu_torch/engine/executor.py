"""Host-side query executor: drives the lattice kernels (the port of the
columnar path of hstream_tpu/engine/executor.py).

Responsibilities, as in the reference:

  * maintain the group-key dictionary (tuple of group values <-> dense id)
  * maintain the time epoch: device time = int32 ms relative to `epoch`,
    re-anchored (rebase) long before int32 overflow
  * track the watermark and the set of open windows ON HOST, so the
    device step never syncs back per batch
  * when the watermark passes win_end + grace: one fused close launch
    (extract + finalize + reset) and one fetch per close cycle, then
    decode keys and apply HAVING + projections
  * EMIT CHANGES mode (the default, as in the reference): after each
    batch, one changelog extract of the touched (key, window) pairs
    (one change per touched pair per micro-batch), and at each window
    end a reset-only close with no fetch

Each micro-batch costs, on the card, one wire decode, one expression
launch when the query has a WHERE clause or a computed aggregate input,
one scatter, one top-k fold when it has TOPK, and in EMIT CHANGES mode
one touched extract (lattice.step_encoded, lattice.extract_touched),
after an H2D copy of its wire words: pinned host buffers, a copy on a
side stream and a CUDA event the step waits on, at most `upload_slots`
copies in flight. SQL NULLs travel as the reference's `__null_a{i}` flag
streams; a NULL in a WHERE column clears the record's valid bit on the
host. Entry points run on the card unless the caller passes
device="cpu", which runs the plain PyTorch versions.

The close and changelog programs come from the shared compiled bundle
(lattice.compiled), each close launch counted in `close_stats` at its
call site. The per-slot close (`_close_windows_ref`: one extract and one
reset launch and one fetch per window) runs only when a caller sets
`_fused_close_ok` to False, as the reference's equivalence tests do; the
reference's automatic degrade to it after a failed fused close is not
ported: a failed launch raises and `_fused_close_ok` stays True.

Session windows run in engine/session.py's SessionExecutor; this
executor refuses them as the reference does.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent import futures
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from hstream_tpu_torch import device as devmod
from hstream_tpu_torch.common.columnar import ColumnarEmit, extend_rows
from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.common.tracing import kernel_family
from hstream_tpu_torch.engine import lattice, transport
from hstream_tpu_torch.engine.expr import (
    BinOp,
    Col,
    Expr,
    columns_of,
    encode_strings,
    eval_host,
    eval_host_vec,
)
from hstream_tpu_torch.engine.plan import AggKind, AggregateNode, AggSpec
from hstream_tpu_torch.engine.types import (
    ColumnType,
    HostBatch,
    Schema,
    StringDictionary,
    canon_key,
)
from hstream_tpu_torch.engine.window import FixedWindow, SessionWindow
from hstream_tpu_torch.stats.devicecost import plane_bytes

REBASE_THRESHOLD = 1 << 30  # re-anchor epoch when relative time passes this

# Shared device->host change-drain workers: ONE small pool for every
# executor in the process, so concurrent queries batch their blocking
# D2H fetches onto drain threads instead of each stalling its own loop.
_DRAIN_POOL: futures.ThreadPoolExecutor | None = None
_DRAIN_POOL_LOCK = threading.Lock()


def _change_drain_pool() -> futures.ThreadPoolExecutor:
    global _DRAIN_POOL
    with _DRAIN_POOL_LOCK:
        if _DRAIN_POOL is None:
            _DRAIN_POOL = futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="change-drain")
        return _DRAIN_POOL

def _align_down(ts: int, step: int) -> int:
    return ts - (ts % step)


_INT_KINDS = (AggKind.COUNT_ALL, AggKind.COUNT, AggKind.APPROX_COUNT_DISTINCT)


def _agg_column(agg: AggSpec, v: np.ndarray) -> np.ndarray:
    """An aggregate's emitted column from its finalized float32 values:
    counts as int64, TOPK as lists of the finite values, else float64."""
    if agg.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT):
        vals = np.empty(len(v), object)
        vals[:] = [[float(x) for x in row[np.isfinite(row)]] for row in v]
        return vals
    if agg.kind in _INT_KINDS:
        return np.rint(v).astype(np.int64)
    return np.asarray(v, np.float64)


# Per-instance read-version nonces: a rebuilt executor must never alias a
# predecessor's version tuple.
_READ_NONCE = itertools.count(1)


@dataclass
class _OpenWindow:
    start_abs: int  # absolute ms
    slot: int


@dataclass
class StagedBatch:
    """A micro-batch encoded (and optionally uploaded) ahead of its step
    launch — the unit of work between the ingest pipeline's encode
    workers and the executor's ordered step loop. Host copies are kept so
    rare control flow (gap split, rebase, epoch change) can fall back to
    the synchronous path."""

    n: int
    combo: Any
    bases: Any                      # np.int32 [n_streams] per-stream bases
    words: Any                      # int32 tensor of the wire words
    epoch: int
    ts_min: int
    ts_max: int
    key_ids: np.ndarray
    ts_ms: np.ndarray
    cols: Mapping[str, np.ndarray]
    nulls: Mapping[str, np.ndarray] | None
    ready: Any = None               # CUDA event: the upload finished


class QueryExecutor:
    """Executes one windowed/global GROUP BY aggregation plan."""

    # the deferred-change knobs (defer_change_decode, change_drain_depth,
    # async_change_drain) apply; a join proxies them onto its inner
    # executor only when this is set
    supports_deferred_changes = True

    def __init__(
        self,
        node: AggregateNode,
        schema: Schema,
        *,
        emit_changes: bool = True,
        initial_keys: int = 1024,
        batch_capacity: int = 4096,
        device: str | torch.device | None = None,
    ):
        if isinstance(node.window, SessionWindow):
            raise SQLCodegenError("session windows use SessionExecutor")
        self.device = devmod.resolve(device)
        self.node = node
        self.schema = schema
        self.emit_changes = emit_changes
        self.batch_capacity = batch_capacity

        # group keys must be plain columns (validated upstream)
        self.group_cols: list[str] = []
        for k in node.group_keys:
            if not isinstance(k, Col):
                raise SQLCodegenError("GROUP BY supports plain columns")
            self.group_cols.append(k.name)

        self.window: FixedWindow | None = node.window
        self.dicts: dict[str, StringDictionary] = {
            name: StringDictionary() for name, t in schema.fields
            if t == ColumnType.STRING
        }

        self._key_ids: dict[tuple, int] = {}
        self._key_rev: list[tuple] = []

        encoded_aggs = []
        for agg in node.aggs:
            if agg.input is not None:
                agg = AggSpec(kind=agg.kind, out_name=agg.out_name,
                              input=encode_strings(agg.input, schema,
                                                   self.dicts),
                              quantile=agg.quantile, k=agg.k)
            encoded_aggs.append(agg)
        self._filter_expr = self._extract_filter()
        if self._filter_expr is not None:
            self._filter_expr = encode_strings(
                self._filter_expr, schema, self.dicts)

        # columns the device step actually needs
        needed: set[str] = set()
        for agg in encoded_aggs:
            if agg.input is not None:
                needed |= columns_of(agg.input)
        if self._filter_expr is not None:
            needed |= columns_of(self._filter_expr)
        self._needed_cols = sorted(needed)
        lattice.check_device_caps(encoded_aggs, needed)

        self.spec = lattice.LatticeSpec(
            n_keys=initial_keys, window=self.window,
            aggs=tuple(encoded_aggs), track_touched=emit_changes)
        # the WHERE mask and computed inputs, as expression programs
        self._progs = lattice.step_programs(self.spec, schema,
                                            self._filter_expr)
        self.state = lattice.init_state(self.spec, self.device)
        self._layout = tuple(
            (name, lattice.layout_tag(schema.type_of(name)))
            for name in self._needed_cols)
        # (null-flag stream name, referenced columns) per aggregate input
        self._null_specs = [
            (lattice.null_key(i), sorted(columns_of(agg.input)))
            for i, agg in enumerate(self.spec.aggs) if agg.input is not None]
        # sticky adaptive wire codec; its encode() runs unlocked on
        # several pipeline workers (transport.BitpackTransport). Null
        # streams, once seen, stay on the wire so the combo converges.
        self._transport = transport.BitpackTransport()
        self._transport_lock = threading.Lock()
        self._null_sticky: set[str] = set()

        self.epoch: int | None = None        # absolute ms anchor, advance-aligned
        self.watermark_abs: int = -1
        self._open: dict[int, _OpenWindow] = {}  # start_abs -> window
        # Window starts whose closure is deferred until the next process()
        # call: populated by the gap-split path so a stream-time jump inside
        # a batch cannot close (and emit) windows that records earlier in
        # the same batch just aggregated into.
        self._no_close: set[int] = set()
        # window starts that received records during the current process()
        # call (populated by _track_windows, cleared per call)
        self._touched_this_call: set[int] = set()
        self.rebase_threshold = REBASE_THRESHOLD
        # Deferred close decode: closing a window launches the fused close
        # but keeps the packed result on the device; drain_closed()
        # fetches and decodes them later, in one fetch per buffer shape.
        self.defer_close_decode = False
        self._pending_closes: list[tuple[list[int], torch.Tensor]] = []
        # Deferred CHANGE decode (EMIT CHANGES): keep the touched extract
        # on the device and decode it later, so the blocking fetch
        # overlaps the next batches' work; change_drain_depth extracts
        # queue before one batched fetch; async_change_drain moves that
        # fetch and its decode onto the shared drain pool, collected
        # strictly in submission order. flush_changes() drains the tail.
        self.defer_change_decode = False
        self.change_drain_depth = 1
        self.async_change_drain = False
        self._pending_changes: list[tuple[int | None, torch.Tensor]] = []
        self._drain_futs: deque = deque()
        # the close contract: ONE close launch and (when not deferred)
        # ONE device->host fetch per close cycle, however many windows
        # are due
        self.close_stats = {"close_cycles": 0, "close_dispatches": 0,
                            "close_fetches": 0}
        # False selects the per-slot close (_close_windows_ref); only a
        # caller sets it, a failed fused close raises
        self._fused_close_ok = True
        # the reference's count of closes degraded to the per-slot path;
        # the port raises instead, so it stays 0
        self.device_fallbacks = 0
        self.dispatch_observer = None   # callable (family, seconds)
        self._compile()
        # cached reverse key-index columns for vectorized key decode:
        # (len(_key_rev) when built, [object array per group column])
        self._key_cols_cache: tuple[int, list[np.ndarray]] = (0, [])
        # H2D staging: at most upload_slots copies in flight; staging a
        # batch past that waits on the OLDEST outstanding copy
        self.upload_slots = 2
        self._upload_ring: deque = deque()
        self._upload_lock = threading.Lock()
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        # per-stage busy-seconds shared with IngestPipeline.stats()
        self.stage_stats: dict[str, float] = {"upload_wait_s": 0.0,
                                              "drain_s": 0.0}
        self._stats_lock = threading.Lock()
        self.late_drops = 0
        self.transfer_stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        # read-plane versioning: read_epoch bumps at every state-mutating
        # choke point (step launch, window close)
        self.read_epoch = 0
        self._read_nonce = next(_READ_NONCE)

    def _extract_filter(self) -> Expr | None:
        """AND of every FilterNode predicate down to the source; any other
        child node raises, so a plan cannot silently skip a filter."""
        from hstream_tpu_torch.engine.plan import FilterNode, SourceNode

        pred: Expr | None = None
        child = self.node.child
        while not isinstance(child, SourceNode):
            if isinstance(child, FilterNode):
                pred = child.predicate if pred is None else \
                    BinOp("AND", pred, child.predicate)
                child = child.child
            else:
                raise SQLCodegenError(
                    f"aggregate over unsupported child node "
                    f"{type(child).__name__}")
        return pred

    def _compile(self) -> None:
        """Take the query's programs from the shared compiled bundle
        (executor.py:305-332 in the reference). The close programs are
        wrapped so close_stats counts every launch at its call site: the
        per-slot close shows two per window, the fused one one per cycle."""
        fns = lattice.compiled(
            self.spec, self.schema, self._filter_expr,
            lattice.touched_max_out(self.spec, self.batch_capacity),
            self._layout)
        self._extract_slot = self._count_close_kernel(fns.extract_slot)
        self._reset_slot = self._count_close_kernel(fns.reset_slot)
        self._extract_reset_slots = self._count_close_kernel(
            fns.extract_reset_slots)
        self._extract_slots = fns.extract_slots  # peek: read path
        self._reset_slots = self._count_close_kernel(fns.reset_slots)
        self._extract_touched = fns.extract_touched

    def _count_close_kernel(self, fn):
        """Wrap a close program so each call bumps close_dispatches and
        runs under the "close" kernel family (executor.py:339-351 in the
        reference)."""

        def counted(*args):
            self.close_stats["close_dispatches"] += 1
            with kernel_family("close", self.dispatch_observer,
                               ready=self._device_values):
                return fn(*args)

        return counted

    # contract: dispatches<=0 fetches<=0
    def _device_values(self):
        """The executor's live device tensors — the device-time
        sampler's target (a zero-arg late binding, read when a sampled
        dispatch starts; the port updates the planes in place, so only
        their device, hence the stream the kernels launch on, matters)."""
        return self.state

    # contract: dispatches<=0 fetches<=0
    def device_plane_bytes(self) -> dict[str, int]:
        """Exact per-plane device bytes of the live lattice state —
        nbytes metadata reads only, zero launches, zero copies."""
        return plane_bytes(self.state)

    # the reference's step launch plus the port's staging wait: the
    # pinned upload on the copy stream may wait on the oldest upload
    # still in flight (_device_stage), where the reference's device_put
    # waits on nothing
    # contract: dispatches<=1 fetches<=1
    def _run_step(self, n: int, key_ids, ts_rel, cols, nulls,
                  wm_rel: int) -> None:
        """Encode one micro-batch with the wire codec, upload it, and
        launch the step's kernels. The wire is sized to the batch
        (cap = n): kernels take any size, so nothing pads. A fired
        device.dispatch fault raises before the encode: the batch has
        touched no plane and no host store yet."""
        if FAULTS.active:  # chaos: fail/delay a step dispatch
            FAULTS.point("device.dispatch")
        combo, bases, words = self._encode(n, key_ids, ts_rel, cols, nulls)
        staged_words, ready = self._device_stage(words)
        self._launch_step(combo, bases, staged_words, ready, n, wm_rel)

    def _encode(self, n: int, key_ids, ts_rel, cols, nulls):
        """Wire-encode one batch with its valid bits (a NULL in a WHERE
        column makes the predicate not true) and null-flag streams. Only
        the sticky-null merge holds the lock; the encode runs unlocked on
        the pipeline's workers."""
        valid, null_streams = self._null_valid_streams(n, nulls)
        with self._transport_lock:
            self._null_sticky.update(null_streams)
            sticky = tuple(self._null_sticky)
        for nk in sticky:
            if nk not in null_streams:
                null_streams[nk] = np.zeros(n, dtype=np.bool_)
        return self._transport.encode(n, n, key_ids, ts_rel, cols,
                                      self._layout, valid=valid,
                                      null_streams=null_streams)

    def _null_valid_streams(self, n: int, nulls):
        """(valid | None, {__null_a{i}: mask}) from a batch's per-column
        null masks (executor.py:817-835 in the reference)."""
        null_streams: dict[str, np.ndarray] = {}
        if nulls is None:
            return None, null_streams
        for nk, refs in self._null_specs:
            nm = np.zeros(n, dtype=np.bool_)
            for c in refs:
                if c in nulls:
                    nm |= np.asarray(nulls[c][:n], np.bool_)
            if nm.any():
                null_streams[nk] = nm
        valid = None
        if self._filter_expr is not None:
            fm = np.zeros(n, dtype=np.bool_)
            for c in columns_of(self._filter_expr):
                if c in nulls:
                    fm |= np.asarray(nulls[c][:n], np.bool_)
            if fm.any():
                valid = ~fm
        return valid, null_streams

    # contract: dispatches<=1 fetches<=0 inline
    def _launch_step(self, combo, bases, words, ready, n: int,
                     wm_rel: int) -> None:
        if ready is not None:
            # the step runs on the caller's stream once the copy stream
            # has finished this upload; the words block stays allocated
            # until the step is done with it
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            words.record_stream(cur)
        self.read_epoch += 1
        # scoped after the wait on the upload: a sampled step's event
        # pair times the kernels, not the copy
        with kernel_family("step", self.dispatch_observer,
                           ready=self._device_values):
            lattice.step_encoded(self.spec, self.state, int(wm_rel), n,
                                 bases, words, combo, n, self._progs)

    # ---- keys --------------------------------------------------------------

    def _key_id(self, row: Mapping[str, Any]) -> int:
        return self.key_id_for(tuple(row.get(c) for c in self.group_cols))

    def _grow_keys(self) -> None:
        new_k = self.spec.n_keys * 2
        self.state = lattice.grow_keys(self.state, self.spec, new_k)
        self.spec = lattice.LatticeSpec(
            n_keys=new_k, window=self.spec.window, aggs=self.spec.aggs,
            hll=self.spec.hll, qcfg=self.spec.qcfg,
            track_touched=self.spec.track_touched)
        self._compile()

    # ---- time --------------------------------------------------------------

    def _advance_step(self) -> int:
        return 1 if self.window is None else self.window.advance_ms

    def _ensure_epoch(self, min_ts: int) -> None:
        if self.epoch is None:
            # anchor so every window that can ever legally receive records
            # has a non-negative relative start: hopping windows reach back
            # size - advance before the first record, and out-of-order
            # records within the grace period reach back another
            # size + grace (window valid while start + size + grace > wm,
            # and the watermark only grows from the first batch's max).
            if self.window is None:
                back = 0
            else:
                w = self.window
                adv = w.advance_ms
                back = (w.size_ms - adv) + \
                    ((w.size_ms + w.grace_ms + adv - 1) // adv) * adv
            self.epoch = _align_down(min_ts, self._advance_step()) - back

    def _maybe_rebase(self, max_ts_abs: int) -> None:
        if self.epoch is None:
            return
        if max_ts_abs - self.epoch < self.rebase_threshold:
            return
        # Re-anchor at the oldest still-open window (or the watermark).
        # delta must be a multiple of advance * n_slots so the slot
        # mapping (start // advance) mod W of every open window is
        # preserved across the rebase.
        anchor = min([w.start_abs for w in self._open.values()]
                     + [self.watermark_abs if self.watermark_abs >= 0 else max_ts_abs])
        period = self._advance_step() * self.spec.n_slots
        delta = _align_down(anchor - self.epoch, period)
        if delta <= 0:
            return
        self._rebase_planes(delta)
        self.epoch = self.epoch + delta

    def _rebase_planes(self, delta: int) -> None:
        """Shift the planes' device-relative time by -delta."""
        lattice.rebase(self.state, delta)

    # ---- ingest ------------------------------------------------------------

    def process(self, rows: Sequence[Mapping[str, Any]],
                ts_ms: Sequence[int]) -> list[dict[str, Any]]:
        """Feed one micro-batch of decoded records; returns emitted rows."""
        if not rows:
            return []
        try:
            return self._process_batch(list(rows), list(ts_ms))
        finally:
            # deferred closes apply only within the call that deferred them
            self._no_close.clear()
            self._touched_this_call.clear()

    def _new_window_starts(self, ts_ms: Sequence[int]) -> set[int]:
        """Window starts this batch's records aggregate into (late ones
        — already past end+grace at the current watermark — excluded,
        matching the device mask).

        Fast path: when the batch's aligned time range is small (the
        steady state — a micro-batch spans a handful of advances), the
        candidate starts are simply every aligned value in
        [align(min)-back, align(max)] — O(range/advance), no scan of
        the 100k+ timestamps. Aligned values with no records just open
        empty windows that close without emitting (count>0 filter), so
        the overapproximation is semantics-free. Sparse/jumpy batches
        fall back to the exact np.unique scan."""
        w = self.window
        ts = np.asarray(ts_ms, dtype=np.int64)
        adv = w.advance_ms
        a_lo = int(ts.min())
        a_hi = int(ts.max())
        a_lo -= a_lo % adv
        a_hi -= a_hi % adv
        span = (a_hi - a_lo) // adv + 1
        back = w.windows_per_record - 1
        # tight gate: a sparse/gappy batch (few records over a wide time
        # range) must use the exact scan, or every aligned gap value
        # becomes a phantom open window tracked (and closed) on host
        if span + back <= min(self.spec.n_slots, 64):
            starts = np.arange(a_lo - back * adv, a_hi + adv, adv)
        else:
            latest = np.unique(ts - ts % adv)
            offs = np.arange(w.windows_per_record, dtype=np.int64) * adv
            starts = np.unique((latest[:, None] - offs[None, :]).ravel())
        if self.watermark_abs >= 0:
            starts = starts[starts + w.size_ms + w.grace_ms
                            > self.watermark_abs]
        return set(starts.tolist())

    def _gap_guard(self, ts_arr: np.ndarray, sub):
        """Gap/slot-collision guard, shared by the row and columnar paths.

        Window start s occupies lattice slot (s // advance) mod W, so two
        distinct live windows whose starts are congruent mod W*advance (a
        stream gap / restart jump) would alias the same slot.

        (a) Exact aliasing among (open windows ∪ this batch's windows):
            split the batch in time order at the first aliasing start and
            force-close only the open windows whose slot the suffix
            actually needs — such windows are provably past end+grace,
            since aliasing requires a gap of W*advance > size+grace.
        (b) A stream-time jump past the slot horizon (even without
            aliasing) defers closure of windows this call's records
            aggregated into until the next call: records within a batch
            are concurrent, so a far-future record must not retroactively
            finalize windows its batch-mates just updated. In-horizon
            progress still closes windows at end of batch as usual.

        `sub(idx)` recursively processes the records at positions `idx`
        (an int ndarray). Returns (emitted_rows, None) when the guard
        split the batch (case a), or (None, new_starts) when the caller
        should proceed — possibly after case (b) recorded deferred closes;
        new_starts is this batch's window-start set for _track_windows."""
        w = self.window
        period = w.advance_ms * self.spec.n_slots
        back = w.size_ms - w.advance_ms
        aligned_min = _align_down(int(ts_arr.min()), w.advance_ms) - back
        anchor = min(list(self._open) + [aligned_min])
        horizon = anchor + (self.spec.n_slots - 1) * w.advance_ms
        new_starts = self._new_window_starts(ts_arr)
        by_res: dict[int, list[int]] = {}
        for s in set(self._open) | new_starts:
            by_res.setdefault(s % period, []).append(s)
        colliding = [sorted(g) for g in by_res.values() if len(g) > 1]
        if colliding:
            cut = min(g[1] for g in colliding)  # first aliasing start
            pre = np.nonzero(ts_arr < cut)[0]
            suf = np.nonzero(ts_arr >= cut)[0]
            out = []
            if len(pre):
                out.extend(sub(pre))
            self._no_close |= set(self._open) & self._touched_this_call
            suf_ts = ts_arr[suf]
            suf_starts = self._new_window_starts(suf_ts)
            suf_res = {s % period for s in suf_starts}
            collide = [s for s in self._open
                       if s % period in suf_res and s not in suf_starts]
            if collide:
                # real closes, not early ones — see proof above; the
                # watermark advances to their close boundary so they
                # cannot reopen into a now-occupied slot
                boundary = max(s + w.size_ms + w.grace_ms for s in collide)
                if boundary > int(suf_ts.max()):
                    raise AssertionError(
                        "aliasing window not due — slot layout invariant "
                        "broken")
                self.watermark_abs = max(self.watermark_abs, boundary)
                out.extend(self._close_windows(sorted(collide)))
            out.extend(sub(suf))
            return out, None
        if int(ts_arr.max()) > horizon:
            self._no_close |= (set(self._open) & self._touched_this_call
                               ) | new_starts
        return None, new_starts

    def _process_batch(self, rows: list, ts_ms: list) -> list[dict[str, Any]]:
        if len(rows) > self.batch_capacity:
            out = []
            for i in range(0, len(rows), self.batch_capacity):
                out.extend(self._process_batch(
                    rows[i:i + self.batch_capacity],
                    ts_ms[i:i + self.batch_capacity]))
            return out

        batch_starts = None
        if self.window is not None:
            def sub(idx):
                return self._process_batch([rows[i] for i in idx],
                                           [ts_ms[i] for i in idx])

            guarded, batch_starts = self._gap_guard(
                np.asarray(ts_ms, dtype=np.int64), sub)
            if guarded is not None:
                return guarded

        n = len(rows)
        batch = HostBatch.from_rows(self.schema, rows, ts_ms, self.dicts,
                                    capacity=n)
        self._ensure_epoch(min(ts_ms))
        self._maybe_rebase(max(ts_ms))

        key_ids = np.array([self._key_id(row) for row in rows], np.int32)

        ts_rel64 = np.asarray(ts_ms, dtype=np.int64) - self.epoch
        if int(ts_rel64.max()) >= (1 << 31):
            # epoch couldn't rebase far enough (an ancient window is still
            # open with an extreme grace) — fail loudly over corrupting.
            raise OverflowError(
                "stream time span exceeds int32 relative range; "
                "reduce grace or close the stalled window")
        wm_rel = (max(self.watermark_abs - self.epoch, -1)
                  if self.watermark_abs >= 0 else -1)
        self._run_step(n, key_ids, ts_rel64, batch.cols, batch.nulls, wm_rel)
        # counted once the step launched (it reads the pre-batch
        # watermark, which the step leaves alone), so a failed dispatch
        # leaves late_drops as it was
        self._note_late(np.asarray(ts_ms, dtype=np.int64))

        # host window bookkeeping
        if self.window is not None:
            self._track_windows(np.asarray(ts_ms, dtype=np.int64),
                                batch_starts)
        new_wm = max(ts_ms)
        if new_wm > self.watermark_abs:
            self.watermark_abs = new_wm
        return self._emit()

    def _emit(self) -> list[dict[str, Any]]:
        """After a step: the changelog (EMIT CHANGES), then the closes;
        a lone columnar batch stays columnar all the way to the caller."""
        out = None
        if self.emit_changes:
            out = extend_rows(out, self._drain_changes())
        out = extend_rows(out, self.close_due_windows())
        return out if out is not None else []

    def _note_late(self, ts_arr: np.ndarray) -> None:
        """Host mirror of the device's late mask: a record
        whose NEWEST window is already past close at the pre-batch
        watermark aggregates nowhere — count it so /metrics carries a
        per-query late-drop series. Steady in-order streams pay one
        integer compare (the quick gate); only batches actually
        carrying late rows pay the vector count."""
        w = self.window
        if w is None or self.watermark_abs < 0 or len(ts_arr) == 0:
            return
        cutoff = self.watermark_abs - w.size_ms - w.grace_ms
        lo = int(ts_arr.min())
        if lo - lo % w.advance_ms > cutoff:
            return
        self.late_drops += int(np.count_nonzero(
            ts_arr - ts_arr % w.advance_ms <= cutoff))

    def _track_windows(self, ts_abs: np.ndarray,
                       starts: set[int] | None = None) -> None:
        advance = self.window.advance_ms
        if starts is None:
            starts = self._new_window_starts(ts_abs)
        for s in starts:
            if s < self.epoch:
                continue
            self._touched_this_call.add(s)
            if s not in self._open:
                slot = (((s - self.epoch) // advance) % self.spec.n_slots)
                self._open[s] = _OpenWindow(start_abs=s, slot=slot)

    def process_columnar(self, key_ids: np.ndarray, ts_ms: np.ndarray,
                         cols: Mapping[str, np.ndarray],
                         nulls: Mapping[str, np.ndarray] | None = None,
                         ) -> list[dict[str, Any]]:
        """Columnar ingest fast path: pre-encoded dense key ids + int64
        absolute-ms timestamps + device columns, skipping per-row Python
        decode (the production ingest path stages columnar batches from
        the native layer). Key-dictionary state must have been populated
        by the caller via key_id_for(); string columns must be pre-encoded
        dictionary ids. Gap jumps that would alias lattice slots go
        through the same _gap_guard split as the row path — rare; the
        steady-state path is pure numpy + one jitted step."""
        if len(key_ids) == 0:
            return []
        try:
            return self._process_columnar(np.asarray(key_ids),
                                          np.asarray(ts_ms, dtype=np.int64),
                                          cols, nulls)
        finally:
            self._no_close.clear()
            self._touched_this_call.clear()

    def _process_columnar(self, key_ids, ts_ms, cols, nulls
                          ) -> list[dict[str, Any]]:
        n = len(key_ids)
        if n > self.batch_capacity:
            out = []
            for i in range(0, n, self.batch_capacity):
                sl = slice(i, i + self.batch_capacity)
                out.extend(self._process_columnar(
                    key_ids[sl], ts_ms[sl],
                    {k: v[sl] for k, v in cols.items()},
                    None if nulls is None else
                    {k: v[sl] for k, v in nulls.items()}))
            return out

        ts_list = np.asarray(ts_ms, dtype=np.int64)
        min_ts, max_ts = int(ts_list.min()), int(ts_list.max())
        batch_starts = None
        if self.window is not None:
            def sub(idx):
                return self._process_columnar(
                    key_ids[idx], ts_list[idx],
                    {k: v[idx] for k, v in cols.items()},
                    None if nulls is None else
                    {k: v[idx] for k, v in nulls.items()})

            guarded, batch_starts = self._gap_guard(ts_list, sub)
            if guarded is not None:
                return guarded

        self._ensure_epoch(min_ts)
        self._maybe_rebase(max_ts)

        ts_rel64 = ts_list - self.epoch
        if int(ts_rel64.max()) >= (1 << 31):
            raise OverflowError(
                "stream time span exceeds int32 relative range")
        wm_rel = (max(self.watermark_abs - self.epoch, -1)
                  if self.watermark_abs >= 0 else -1)
        self._run_step(n, key_ids, ts_rel64, cols, nulls, wm_rel)
        self._note_late(ts_list)  # after the step, as in _process_batch

        if self.window is not None:
            self._track_windows(ts_list, batch_starts)
        if max_ts > self.watermark_abs:
            self.watermark_abs = max_ts
        return self._emit()

    # ---- pipelined ingest (stage on one thread, step on another) ----------

    # The port's staging differs from the reference's device_put: its one
    # fetch is the wait on the oldest in-flight upload of the pinned
    # ring (a copy-stream event, on the encode worker), never a kernel.
    # contract: dispatches<=0 fetches<=1 inline
    def _device_stage(self, words: np.ndarray):
        """H2D staging of one wire buffer -> (device int32 tensor, CUDA
        event | None). On the card: a pinned host copy, then an async
        copy on the executor's copy stream, recorded by an event the
        step waits on; at most `upload_slots` copies stay in flight, a
        stage past that waits on the OLDEST (the wait blocks an encode
        worker, never the step thread). On the CPU the words are used
        where they lie."""
        self.transfer_stats["h2d_bytes"] += int(words.nbytes)
        host = torch.from_numpy(words.view(np.int32))
        if self._copy_stream is None:
            return host, None
        pinned = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty(host.shape, dtype=torch.int32,
                              device=self.device)
            dev.copy_(pinned, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        wait = None
        with self._upload_lock:
            self._upload_ring.append((ready, pinned))
            if len(self._upload_ring) > max(self.upload_slots, 1):
                wait = self._upload_ring.popleft()[0]
        if wait is not None:
            t0 = time.perf_counter()
            wait.synchronize()
            with self._stats_lock:
                self.stage_stats["upload_wait_s"] += \
                    time.perf_counter() - t0
        return dev, ready

    # the port's staging may wait once on the oldest upload still in
    # flight (_device_stage); the reference's device_put waits on nothing
    # contract: dispatches<=0 fetches<=1
    def stage_columnar(self, key_ids, ts_ms, cols, nulls=None
                       ) -> StagedBatch | None:
        """Encode and upload one micro-batch ahead of its step — safe to
        run on an encode worker while the main thread launches earlier
        batches' steps. Launches no kernel and fetches nothing; its one
        wait is on an earlier upload when the pinned ring is full. Rare
        control flow (epoch rebase, int32 overflow, gap splits) falls
        back to the synchronous path inside process_staged()."""
        key_ids = np.asarray(key_ids, dtype=np.int32)
        n = len(key_ids)
        if n == 0:
            return None
        if n > self.batch_capacity:
            raise ValueError("stage_columnar: batch exceeds capacity; "
                             "split upstream")
        ts = np.asarray(ts_ms, dtype=np.int64)
        self._ensure_epoch(int(ts.min()))
        # single epoch read: a concurrent rebase on the caller thread
        # between here and the stamp below must not split the two (the
        # stamp is what process_staged validates against)
        epoch = self.epoch
        ts_rel64 = ts - epoch
        staged = StagedBatch(
            n=n, combo=None, bases=None, words=None, epoch=epoch,
            ts_min=int(ts.min()), ts_max=int(ts.max()),
            key_ids=key_ids, ts_ms=ts, cols=cols, nulls=nulls)
        if int(ts_rel64.max()) >= (1 << 31):
            return staged  # combo=None -> synchronous fallback (rebases)
        combo, bases, words = self._encode(n, key_ids, ts_rel64, cols, nulls)
        staged.combo = combo
        staged.bases = bases
        staged.words, staged.ready = self._device_stage(words)
        return staged

    def process_staged(self, staged: StagedBatch | None
                       ) -> list[dict[str, Any]]:
        """Ordered step launch for a staged batch (main thread)."""
        if staged is None:
            return []
        if (staged.combo is None or staged.epoch != self.epoch
                or staged.ts_max - self.epoch >= self.rebase_threshold):
            # stale encode (epoch rebased since) or wide time span:
            # synchronous path re-encodes with full handling
            try:
                return self._process_columnar(staged.key_ids, staged.ts_ms,
                                              staged.cols, staged.nulls)
            finally:
                self._no_close.clear()
                self._touched_this_call.clear()
        try:
            return self._process_staged(staged)
        finally:
            self._no_close.clear()
            self._touched_this_call.clear()

    # contract: dispatches<=1 fetches<=0
    def _process_staged(self, staged: StagedBatch) -> list[dict[str, Any]]:
        ts_list = staged.ts_ms
        batch_starts = None
        if self.window is not None:
            def sub(idx):
                return self._process_columnar(
                    staged.key_ids[idx], ts_list[idx],
                    {k: np.asarray(v)[idx] for k, v in staged.cols.items()},
                    None if staged.nulls is None else
                    {k: np.asarray(v)[idx] for k, v in staged.nulls.items()})

            guarded, batch_starts = self._gap_guard(ts_list, sub)
            if guarded is not None:
                return guarded

        wm_rel = (max(self.watermark_abs - self.epoch, -1)
                  if self.watermark_abs >= 0 else -1)
        self._note_late(ts_list)
        self._launch_step(staged.combo, staged.bases, staged.words,
                          staged.ready, staged.n, wm_rel)

        if self.window is not None:
            self._track_windows(ts_list, batch_starts)
        if staged.ts_max > self.watermark_abs:
            self.watermark_abs = staged.ts_max
        return self._emit()

    def key_id_for(self, key: tuple) -> int:
        """Dense id for a group-key tuple (columnar-path key dictionary).
        Float key values are canonicalized through float32 so JSON and
        columnar producers agree on group identity."""
        key = canon_key(key)
        kid = self._key_ids.get(key)
        if kid is None:
            kid = len(self._key_rev)
            if kid >= self.spec.n_keys:
                self._grow_keys()
            self._key_ids[key] = kid
            self._key_rev.append(key)
        return kid

    # ---- emission ----------------------------------------------------------

    def _postprocess(self, row: dict[str, Any]) -> dict[str, Any] | None:
        if self.node.having is not None:
            if not eval_host(self.node.having, row):
                return None
        if self.node.post_projections:
            projected = {}
            for name, expr in self.node.post_projections:
                projected[name] = eval_host(expr, row)
            # keep window metadata
            for meta in ("winStart", "winEnd"):
                if meta in row:
                    projected[meta] = row[meta]
            return projected
        return row

    # contract: dispatches<=1 fetches<=1
    def _close_windows(self, starts: list[int]) -> list[dict[str, Any]]:
        """Pop + close every window in `starts` with ONE fused close
        launch (extract + finalize + reset) and, unless deferred, ONE
        device->host fetch, however many windows are due. In EMIT CHANGES
        mode the launch only resets and nothing is fetched: the changelog
        already carried the final values. A failed launch raises: there
        is no automatic degrade to the per-slot close. A fired
        device.activate fault raises before any window is popped, so the
        due windows stay open and the next call closes them."""
        if not starts:
            return []
        if FAULTS.active and self._fused_close_ok:
            # chaos: provoke a fused-close failure
            FAULTS.point("device.activate")
        ows = [(s, self._open.pop(s).slot) for s in starts]
        self.read_epoch += 1
        self.close_stats["close_cycles"] += 1
        if not self._fused_close_ok:
            return self._close_windows_ref(ows)
        slots = lattice.pad_slots([slot for _s, slot in ows])
        rows: Any = []
        if self.emit_changes:
            self.state = self._reset_slots(self.state, slots)
        elif self.defer_close_decode:
            # keep the packed batch on the device; no host sync
            self.state, packed = self._extract_reset_slots(self.state, slots)
            self._pending_closes.append((list(starts), packed))
        else:
            self.state, packed = self._extract_reset_slots(self.state, slots)
            self.close_stats["close_fetches"] += 1
            packed_host = packed.cpu().numpy()
            self.transfer_stats["d2h_bytes"] += packed_host.nbytes
            rows = self._decode_extract_batch(packed_host, starts)
        for s in starts:
            self._no_close.discard(s)
        return rows

    def _close_windows_ref(self, ows: list
                           ) -> "ColumnarEmit | list[dict[str, Any]]":
        """The per-slot close (executor.py:1213-1235 in the reference):
        one extract and one reset launch per window and one fetch per
        extracted window (counted in close_fetches, which the reference
        leaves out here), each window decoded as a one-slot batch.
        Reached only when a caller has set _fused_close_ok to False."""
        out = None
        for s, slot in ows:
            if not self.emit_changes:
                # the per-slot fallback (a caller turned the fused close
                # off); one fetch per window is its price
                # analyze: ok dispatch-sync — reference close fallback
                packed = self._extract_slot(self.state, slot).cpu().numpy()
                self.close_stats["close_fetches"] += 1
                self.transfer_stats["d2h_bytes"] += packed.nbytes
                out = extend_rows(
                    out, self._decode_extract_batch(packed[None], [s]))
            self.state = self._reset_slot(self.state, slot)
            self._no_close.discard(s)
        return out if out is not None else []

    # contract: dispatches<=0 fetches<=1
    def drain_closed(self) -> list[dict[str, Any]]:
        """Decode every deferred window close. Pending close cycles fetch
        in ONE device->host copy per buffer shape (key growth between two
        closes changes K, and the cycle width changes P). A fired
        device.fetch fault raises before the fetch: every pending close
        stays pending for the next drain."""
        if not self._pending_closes:
            return []
        if FAULTS.active:  # chaos: fail/delay the deferred-close drain
            FAULTS.point("device.fetch")
        out = None
        by_shape: dict[tuple, list[tuple[list[int], torch.Tensor]]] = {}
        for starts, packed in self._pending_closes:
            by_shape.setdefault(tuple(packed.shape), []).append(
                (starts, packed))
        for group in by_shape.values():
            self.close_stats["close_fetches"] += 1
            if len(group) == 1:
                stacked = group[0][1].cpu().numpy()[None]
            else:
                stacked = lattice.stack_pow2(
                    [p for _, p in group]).cpu().numpy()
            self.transfer_stats["d2h_bytes"] += stacked.nbytes
            for (starts, _), packed in zip(group, stacked):
                out = extend_rows(
                    out, self._decode_extract_batch(packed, starts))
        self._pending_closes.clear()  # only after every decode succeeded
        return out if out is not None else []

    # ---- the changelog (EMIT CHANGES) --------------------------------------

    # contract: dispatches<=1 fetches<=1
    def _drain_changes(self) -> "ColumnarEmit | list[dict[str, Any]]":
        """One changelog extract of this batch's touched (key, window)
        pairs (one launch). Decoded now, or kept on the device when
        defer_change_decode is set: more than change_drain_depth pending
        extracts are fetched together, on the shared drain pool when
        async_change_drain is set (the newest stays pending)."""
        self.state, packed = self._extract_touched(self.state)
        if not self.defer_change_decode:
            host = packed.cpu().numpy()
            self.transfer_stats["d2h_bytes"] += host.nbytes
            return self._decode_changes(host, self.epoch)
        # the epoch is captured WITH the extract: a rebase between the
        # extract and the deferred decode must not shift window bounds
        self._pending_changes.append((self.epoch, packed))
        out = self._collect_drained(block=False)
        if len(self._pending_changes) <= max(self.change_drain_depth, 1):
            return out if out is not None else []
        keep = self._pending_changes.pop()
        batch = self._pending_changes
        self._pending_changes = [keep]
        if self.async_change_drain:
            # the extracts were made on this thread's stream; the drain
            # thread's fetch waits on their event (device.handoff)
            mark = devmod.handoff([buf for _, buf in batch])
            self._drain_futs.append(
                _change_drain_pool().submit(self._drain_job, batch, mark))
            out = extend_rows(out, self._collect_drained(block=False))
        else:
            out = extend_rows(out, self._decode_pending(batch))
        return out if out is not None else []

    def _drain_job(self, batch: list, mark=None) -> "ColumnarEmit | list":
        """One async drain unit (drain-pool thread). Reads only
        append-only or immutable executor state: _key_rev only grows,
        spec.aggs never changes, and no kernel writes the packed
        extracts after they were made. `mark` is the producer's event
        (device.handoff), waited on before the fetch."""
        t0 = time.perf_counter()
        try:
            devmod.receive(mark, [buf for _, buf in batch])
            return self._decode_pending(batch)
        finally:
            with self._stats_lock:
                self.stage_stats["drain_s"] += time.perf_counter() - t0

    def _collect_drained(self, block: bool):
        """Finished async drains, strictly in submission order (a done
        future behind an unfinished one waits); block=True takes all."""
        rows = None
        while self._drain_futs:
            f = self._drain_futs[0]
            if not block and not f.done():
                break
            self._drain_futs.popleft()
            rows = extend_rows(rows, f.result())
        return rows

    def flush_changes(self) -> list[dict[str, Any]]:
        """Decode every deferred changelog extract (the async drain queue
        first, then the still-pending tail)."""
        rows = extend_rows(self._collect_drained(block=True),
                           self._decode_pending(self._pending_changes))
        self._pending_changes = []
        return rows if rows is not None else []

    def has_pending_changes(self) -> bool:
        """True when deferred change extracts still hold rows."""
        return bool(self._pending_changes or self._drain_futs)

    # contract: dispatches<=0 fetches<=1
    def _decode_pending(self, pending: list
                        ) -> "ColumnarEmit | list[dict[str, Any]]":
        """Decode deferred change extracts, fetching them in ONE
        device->host copy per buffer shape (key growth changes it)."""
        if not pending:
            return []
        if len(pending) == 1:
            epoch, buf = pending[0]
            host = buf.cpu().numpy()
            self.transfer_stats["d2h_bytes"] += host.nbytes
            return self._decode_changes(host, epoch)
        rows = None
        by_shape: dict[tuple, list] = {}
        for ep, buf in pending:
            by_shape.setdefault(tuple(buf.shape), []).append((ep, buf))
        for group in by_shape.values():
            stacked = lattice.stack_pow2([b for _, b in group]).cpu().numpy()
            self.transfer_stats["d2h_bytes"] += stacked.nbytes
            for (ep, _), buf in zip(group, stacked):
                rows = extend_rows(rows, self._decode_changes(buf, ep))
        return rows if rows is not None else []

    def _decode_changes(self, packed: np.ndarray, epoch: int | None
                        ) -> "ColumnarEmit | list[dict[str, Any]]":
        """Columnar changelog decode: unpack the touched extract, gather
        the group-key columns through the cached reverse index, finalize
        the aggregate columns, then HAVING and projections."""
        n, kidx, win_start_rel, outs = lattice.unpack_touched_rows(
            self.spec, packed)
        if n == 0:
            return []
        cols: dict[str, Any] = {}
        kidx = kidx.astype(np.int64)
        for name, arr in zip(self.group_cols, self._key_rev_columns()):
            cols[name] = arr[kidx]
        for agg in self.spec.aggs:
            cols[agg.out_name] = _agg_column(agg, outs[agg.out_name])
        if self.window is not None:
            ws = win_start_rel.astype(np.int64) + epoch
            cols["winStart"] = ws
            cols["winEnd"] = ws + self.window.size_ms
        return self._postprocess_cols(cols, n)

    def close_due_windows(self) -> list[dict[str, Any]]:
        """Extract + reset every open window past end+grace: one fused
        device dispatch + one fetch for the whole cycle. Host-driven."""
        if self.window is None or self.watermark_abs < 0:
            return []
        w = self.window
        due = [s for s in self._open
               if s + w.size_ms + w.grace_ms <= self.watermark_abs
               and s not in self._no_close]
        return self._close_windows(sorted(due))

    def _key_rev_columns(self) -> list[np.ndarray]:
        """Per-group-column object arrays over the key dictionary, for
        vectorized key decode (one gather per column instead of one
        dict per row). Rebuilt only when keys were added."""
        version = len(self._key_rev)
        if self._key_cols_cache[0] != version:
            cols = []
            for g in range(len(self.group_cols)):
                arr = np.empty(version, object)
                for i, key in enumerate(self._key_rev):
                    arr[i] = key[g]
                cols.append(arr)
            self._key_cols_cache = (version, cols)
        return self._key_cols_cache[1]

    def _decode_extract_batch(self, packed: np.ndarray,
                              starts: Sequence[int | None]
                              ) -> "ColumnarEmit | list[dict[str, Any]]":
        """Vectorized decode of a batched extract buffer [P, 2+rows, K]
        into a ColumnarEmit: key decode is a cached reverse-index
        gather, agg finalization is columnar numpy, HAVING evaluates
        columnwise — no per-kid Python loop. `starts[p]` is window p's
        absolute start (None when windowless)."""
        count = packed[:, 0, :]
        widx, kids = np.nonzero(count > 0)
        if len(widx) == 0:
            return []
        cols: dict[str, Any] = {}
        for name, arr in zip(self.group_cols, self._key_rev_columns()):
            cols[name] = arr[kids]
        outs = lattice.gather_extract_batch(self.spec, packed, widx, kids)
        for agg in self.spec.aggs:
            cols[agg.out_name] = _agg_column(agg, outs[agg.out_name])
        if self.window is not None and starts and starts[0] is not None:
            ws = np.asarray(starts, np.int64)[widx]
            cols["winStart"] = ws
            cols["winEnd"] = ws + self.window.size_ms
        return self._postprocess_cols(cols, len(widx))

    def _postprocess_cols(self, cols: dict[str, Any], n: int
                          ) -> "ColumnarEmit | list[dict[str, Any]]":
        """HAVING + SELECT projections over a columnar batch. The
        vectorized evaluator covers the numeric/comparison core; any
        op outside it falls back to the per-row interpreter so
        semantics match the legacy path exactly."""
        if self.node.having is not None:
            try:
                keep = np.broadcast_to(
                    np.asarray(eval_host_vec(self.node.having, cols),
                               np.bool_), (n,))
            except Exception:  # noqa: BLE001 — host-only op / NULLs:
                return self._postprocess_rows(ColumnarEmit(cols, n))
            if not keep.all():
                cols = {k: np.asarray(v)[keep] for k, v in cols.items()}
                n = int(keep.sum())
                if n == 0:
                    return []
        if self.node.post_projections:
            try:
                projected: dict[str, Any] = {}
                for name, expr in self.node.post_projections:
                    v = eval_host_vec(expr, cols)
                    projected[name] = np.broadcast_to(
                        np.asarray(v), (n,)) if np.ndim(v) == 0 \
                        else np.asarray(v)
                for meta in ("winStart", "winEnd"):
                    if meta in cols:
                        projected[meta] = cols[meta]
                cols = projected
            except Exception:  # noqa: BLE001
                return self._postprocess_rows(ColumnarEmit(cols, n))
        return ColumnarEmit(cols, n)

    def _postprocess_rows(self, rows) -> list[dict[str, Any]]:
        """Per-row HAVING/projection fallback (host-only ops)."""
        out = []
        for row in rows:
            row = self._postprocess(row)
            if row is not None:
                out.append(row)
        return out

    # ---- pull queries (materialized views) ---------------------------------

    # contract: dispatches<=0 fetches<=0
    def read_version(self) -> tuple:
        """Exact version of the peek-visible aggregate: equal tuples
        guarantee peek() would return the same rows (the read cache's
        validity key). Host ints only; lock-free readers get
        at worst a spurious mismatch."""
        return ("agg", self._read_nonce, self.read_epoch,
                self.close_stats["close_cycles"], self.watermark_abs)

    # contract: dispatches<=0 fetches<=0
    def live_min_win_end(self) -> int | None:
        """Smallest winEnd any live (open OR due-but-unclosed) window
        could emit, or None when no live window exists. Lets a reader
        whose WHERE bounds winEnd strictly below this skip peek()
        entirely — closed rows alone answer the query."""
        if self.window is None or not self._open:
            return None
        return min(self._open) + self.window.size_ms

    # contract: dispatches<=1 fetches<=1
    def peek(self) -> list[dict[str, Any]]:
        """Current (open-window) aggregate rows without resetting state:
        ONE extract-only close launch + ONE fetch covers every open
        window."""
        if self.window is None:
            packed = self._extract_slots(
                self.state, lattice.pad_slots([0])).cpu().numpy()
            return self._decode_extract_batch(packed, [None])
        starts = sorted(self._open)
        if not starts:
            return []
        slots = lattice.pad_slots([self._open[s].slot for s in starts])
        packed = self._extract_slots(self.state, slots).cpu().numpy()
        return self._decode_extract_batch(packed, starts)

    # contract: dispatches<=0 fetches<=1
    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
