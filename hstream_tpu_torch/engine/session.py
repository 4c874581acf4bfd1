"""Session-window aggregation (the port of hstream_tpu/engine/session.py).

Reference semantics (SessionWindowedStream.hs:84-118): a record at ts
belongs to session [ts, ts]; sessions of the same key merge when their
gap-extended intervals overlap (ts within `gap` of the session edge);
a session closes when the watermark passes end + gap + grace.

Session merge is an associative monoid fold over ts-ordered segments,
so the hot path runs on the card (engine/session_lattice.py): open
sessions live in an arena sorted by (key code, t0), and each micro-batch
is ONE step wrapper call — sort (arena + batch) by (code, ts),
segmented-scan the chain boundaries (gap > timeout = new session), fold
each chain into a slot of the other of two preallocated arenas with
monoid accumulator merges. The step fetches nothing; closed sessions
come back through the pow2-padded extract (one launch + one fetch per
close cycle) and emit as a ColumnarEmit.

The HOST engine below is the equivalence reference and serves the
configurations that stay on the host (`use_device_sessions=False`,
EMIT CHANGES sessions, TOPK lists): per-batch segmentation vectorized in
numpy, per-segment accumulators via reduceat, segment merges into
per-key Python session state. The device path keeps an exact host-side
interval MIRROR (code, t0, t1 — no accumulators) of the arena, updated
with the numpy twin of the kernels' sort + scan: the mirror decides
late-record drops, close cycles, capacity and slot indices with zero
device syncs.

Modes: "record" packs raw records (one int32 buffer per batch, uploaded
through pinned memory and a side stream) and runs the session step
kernel; "segment" pre-reduces rows into per-segment planes on the host
and runs the session merge kernel. The card defaults to record, the CPU
(device="cpu", the plain PyTorch versions) to segment;
`device_session_mode` forces either.

Failure policy — where the port differs from the reference: a failed
activation, step, extract or remap RAISES (the reference degraded the
executor to the host engine, counted in device_fallbacks). The port
never falls back from a kernel to anything else, and never moves state
that lies on the card to the host engine:
- a batch chain merging any number of open sessions stays on the device
  (the sort, scan and fold handle any chain; the reference's
  chain_merge_limit only chose its host engine);
- a stream span that reaches the int32 relative-time range while an old
  session pins the epoch raises NotPortedError on the card; on
  device="cpu" the state moves to the host engine as in the reference
  (counted in device_fallbacks);
- a record-mode aggregate input the device expression compiler refuses
  raises NotPortedError on the card; on device="cpu" the host engine
  serves the query as in the reference.

With a mesh whose key axis has more than one shard, the arena is key-
sharded (parallel/lattice.py ShardedSessionLattice, session.py:1090 in
the reference): key shard s holds the chains of the codes with code mod
n_shards == s in mirror order; every batch goes to every shard, whose
kernels drop what other shards own; the code compaction keeps residues
(dead mirror rows keep theirs as negative codes); an extract takes
per-shard slot lists and its buffer is flattened back into mirror order.
The batch and segment buffers are sized to the batch (the reference's
sticky pow2 capacities bounded XLA recompiles).
"""

from __future__ import annotations

import logging
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from hstream_tpu_torch import device as devmod
from hstream_tpu_torch.common.columnar import ColumnarEmit, extend_rows
from hstream_tpu_torch.common.errors import NotPortedError, SQLCodegenError
from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.common.tracing import kernel_family
from hstream_tpu_torch.engine import session_lattice as sl
from hstream_tpu_torch.engine.executor import _READ_NONCE, QueryExecutor
from hstream_tpu_torch.engine.expr import (
    Col,
    columns_of,
    encode_strings,
    eval_host,
    eval_host_vec,
)
from hstream_tpu_torch.engine.lattice import (
    agg_width, check_device_caps, pad_slots, stack_pow2)
from hstream_tpu_torch.engine.plan import AggKind, AggregateNode, AggSpec
from hstream_tpu_torch.engine.sketches import HLLConfig, QuantileConfig
from hstream_tpu_torch.engine.types import (
    ColumnType,
    HostBatch,
    Schema,
    StringDictionary,
    canon_key,
    round_up_pow2,
)
from hstream_tpu_torch.engine.window import SessionWindow
from hstream_tpu_torch.stats.devicecost import plane_bytes

log = logging.getLogger("hstream_tpu_torch.session")

# sentinel return of the device ingest helpers: the executor moved its
# state to the host engine mid-plan (a semantic route, not a failure);
# the caller reruns the batch through the host path
_DEGRADED = object()

# packed batches whose pinned staging buffers stay referenced, so a
# batch's upload overlaps the step of the one before it
_UPLOAD_SLOTS = 2


# ---- numpy sketch helpers (host-side finalize) -----------------------------

def hll_update_np(values: np.ndarray, cfg: HLLConfig):
    """(register idx, rank) per value — numpy mirror of
    sketches.hll_update_indices (same hash, same estimates merge)."""
    v = np.ascontiguousarray(values, dtype=np.float32)
    v = np.where(v == 0.0, np.float32(0.0), v)
    h = v.view(np.uint32).copy()
    h ^= h >> 16
    h = (h * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    h ^= h >> 13
    h = (h * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    h ^= h >> 16
    p = cfg.precision
    reg = (h >> (32 - p)).astype(np.int64)
    w = (h << p) & np.uint32(0xFFFFFFFF)
    # count leading zeros of remaining bits
    rank = np.zeros(len(v), dtype=np.int64)
    x = w.copy()
    for shift in (16, 8, 4, 2, 1):
        empty = (x >> (32 - shift)) == 0
        rank += np.where(empty, shift, 0)
        x = np.where(empty, (x << shift) & np.uint32(0xFFFFFFFF), x)
    rank = np.where(w == 0, 32, rank)
    rank = np.minimum(rank + 1, 32 - p + 1).astype(np.int8)
    return reg, rank


def hll_estimate_np(registers: np.ndarray, cfg: HLLConfig) -> np.ndarray:
    """HLL estimate over the last axis: accepts one register set [m] or
    a batch [..., m] (batched session closes finalize in one call)."""
    m = cfg.m
    if m == 16:
        alpha = 0.673
    elif m == 32:
        alpha = 0.697
    elif m == 64:
        alpha = 0.709
    else:
        alpha = 0.7213 / (1 + 1.079 / m)
    regs = np.asarray(registers).astype(np.float64)
    raw = alpha * m * m / np.sum(np.exp2(-regs), axis=-1)
    zeros = np.sum(np.asarray(registers) == 0, axis=-1)
    lin = m * np.log(m / np.maximum(zeros, 1))
    return np.where((raw <= 2.5 * m) & (zeros > 0), lin, raw)


def quantile_bin_np(values: np.ndarray, cfg: QuantileConfig) -> np.ndarray:
    v = np.maximum(values.astype(np.float64), 0.0)
    safe = np.maximum(v, cfg.min_value)
    b = np.floor(np.log(safe / cfg.min_value) / cfg.gamma_log).astype(
        np.int64) + 1
    b = np.clip(b, 1, cfg.n_bins - 1)
    return np.where(v < cfg.min_value, 0, b)


def quantile_estimate_np(hist: np.ndarray, q: float,
                         cfg: QuantileConfig) -> np.ndarray:
    """Quantile estimate over the last axis: one histogram [n_bins] or
    a batch [..., n_bins]. argmax(cdf >= target) is searchsorted-left
    with a batch axis."""
    cdf = np.cumsum(hist, axis=-1)
    total = cdf[..., -1]
    target = q * total
    idx = np.argmax(cdf >= target[..., None], axis=-1)
    idx = np.minimum(idx, cfg.n_bins - 1)
    log_lo = (idx - 1.0) * cfg.gamma_log
    est = cfg.min_value * np.exp(log_lo + 0.5 * cfg.gamma_log)
    return np.where((idx == 0) | (total == 0), 0.0, est)


# ---- interval chain merge (numpy twin of the device kernel) -----------------

def merge_chains_np(code: np.ndarray, t0: np.ndarray, t1: np.ndarray,
                    gap: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chain-merge intervals by gap-overlap: sort by (code, t0, t1),
    break a chain at a code change or where t0 exceeds the running max
    end + gap — the exact fixpoint of sequential merge-on-overlap
    (interval clustering is confluent: merging only grows intervals).
    This is the numpy twin of session_lattice.chain_slots, so the
    returned chains are, in order, exactly the device arena's slots.

    Returns (code, t0, t1) per chain. (The reference also returns how
    many open sessions one chain merges, for its chain limit; the port
    has no such limit.)"""
    n = len(code)
    if n == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), e.copy()
    order = np.lexsort((t1, t0, code))
    c = code[order].astype(np.int64)
    a = t0[order].astype(np.int64)
    b = t1[order].astype(np.int64)
    newrun = np.empty(n, np.bool_)
    newrun[0] = True
    newrun[1:] = c[1:] != c[:-1]
    # segmented running max of end via one accumulate: offset each code
    # run into its own disjoint value band (span bounded by the int32
    # relative-time guard, codes < 2^22, so the product fits int64)
    base = int(b.min())
    span = int(b.max()) - base + int(gap) + 2
    runmax = np.maximum.accumulate(c * span + (b - base)) - c * span + base
    prev = np.empty(n, np.int64)
    prev[0] = base - gap - 1
    prev[1:] = runmax[:-1]
    brk = newrun | (a > prev + gap)
    starts = np.nonzero(brk)[0]
    mcode = c[starts]
    mt0 = a[starts]
    mt1 = np.maximum.reduceat(b, starts)
    return mcode, mt0, mt1


# ---- session state ---------------------------------------------------------

@dataclass
class _Session:
    start: int
    end: int                      # last record ts
    accs: dict[str, Any] = field(default_factory=dict)


def _acc_init(agg: AggSpec, hll: HLLConfig, qcfg: QuantileConfig):
    if agg.kind in (AggKind.COUNT_ALL, AggKind.COUNT):
        return 0
    if agg.kind in (AggKind.SUM,):
        return 0.0
    if agg.kind == AggKind.AVG:
        return (0.0, 0)
    if agg.kind == AggKind.MIN:
        return math.inf
    if agg.kind == AggKind.MAX:
        return -math.inf
    if agg.kind == AggKind.APPROX_COUNT_DISTINCT:
        return np.zeros(hll.m, dtype=np.int8)
    if agg.kind == AggKind.APPROX_QUANTILE:
        return np.zeros(qcfg.n_bins, dtype=np.int64)
    if agg.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT):
        return []  # descending value list, trimmed to k
    raise SQLCodegenError(f"session agg {agg.kind} unsupported")


def _acc_merge(agg: AggSpec, a, b):
    if agg.kind in (AggKind.COUNT_ALL, AggKind.COUNT, AggKind.SUM):
        return a + b
    if agg.kind == AggKind.AVG:
        return (a[0] + b[0], a[1] + b[1])
    if agg.kind == AggKind.MIN:
        return min(a, b)
    if agg.kind == AggKind.MAX:
        return max(a, b)
    if agg.kind == AggKind.APPROX_COUNT_DISTINCT:
        return np.maximum(a, b)
    if agg.kind == AggKind.APPROX_QUANTILE:
        return a + b
    if agg.kind == AggKind.TOPK:
        return sorted(a + b, reverse=True)[: agg_width(agg)]
    if agg.kind == AggKind.TOPK_DISTINCT:
        return sorted(set(a) | set(b), reverse=True)[: agg_width(agg)]
    raise SQLCodegenError(f"session agg {agg.kind} unsupported")


class SessionExecutor:
    """Windowed-by-session grouped aggregation.

    API-compatible with QueryExecutor: process(rows, ts_ms) -> emitted
    rows; emitted rows carry winStart/winEnd = [session start,
    session end + gap) like the reference's session serde. The hot path
    runs on the card unless `device="cpu"` (module docstring); the host
    merge engine below is the equivalence reference."""

    # tasks.py columnar feed capability: process_columnar takes
    # (ts, named numpy columns, nulls) — the join's _plain_columns shape
    supports_columnar_sessions = True

    # aggregate kinds the device arena carries; TOPK value lists stay
    # host-only (no fixed-width monoid plane worth it for sessions)
    _DEVICE_AGG_KINDS = frozenset({
        AggKind.COUNT_ALL, AggKind.COUNT, AggKind.SUM, AggKind.AVG,
        AggKind.MIN, AggKind.MAX, AggKind.APPROX_COUNT_DISTINCT,
        AggKind.APPROX_QUANTILE,
    })

    REBASE_THRESHOLD = 1 << 30  # re-anchor epoch past this relative ms

    def __init__(self, node: AggregateNode, schema: Schema, *,
                 emit_changes: bool = False,
                 hll: HLLConfig = HLLConfig(),
                 qcfg: QuantileConfig = QuantileConfig(),
                 device: str | torch.device | None = None,
                 mesh=None):
        if not isinstance(node.window, SessionWindow):
            raise SQLCodegenError("SessionExecutor needs a SessionWindow")
        # a mesh whose key axis has >1 shards key-shards the session arena
        # (parallel/lattice.py ShardedSessionLattice: chain merge is
        # key-local, so every device op stays per shard); a mesh with one
        # key shard keeps the single-card kernels (session.py:1090)
        self.mesh = mesh
        # launches of the key-sharded arena's programs; the query task
        # mirrors deltas into the sharded_dispatches stat family
        self.sharded_dispatches = 0
        self.device = devmod.resolve(device)
        self.node = node
        self.schema = schema
        self.window: SessionWindow = node.window
        self.emit_changes = emit_changes
        self.hll = hll
        self.qcfg = qcfg
        self.group_cols = [g.name for g in node.group_keys]
        self.aggs = list(node.aggs)
        self.watermark: int = -1
        # key tuple -> list[_Session], kept sorted by start
        self.sessions: dict[tuple, list[_Session]] = {}
        self._filter = QueryExecutor._extract_filter(self)  # same chain walk
        check_device_caps(self.aggs, set().union(*(
            columns_of(e) for e in [a.input for a in self.aggs]
            + [self._filter] if e is not None)))
        # batch key-encoding caches (rebuildable; not snapshot state) —
        # in device mode the codes ARE the arena's sort keys, so the
        # cache bound compacts (order-preserving remap kernel) instead
        # of clearing
        self._code_of: dict[tuple, int] = {}   # canon key -> code
        self._code_rev: list[tuple] = []       # code -> canon key
        self._raw_memo: dict[Any, int] = {}    # raw value(s) -> code
        self._input_cache: dict = {}           # per-batch input columns
        # device session path (engine/session_lattice.py kernels);
        # use_device_sessions=False pins the host reference engine
        self.use_device_sessions = True
        self._dev: dict | None = None
        self._device_refusal: str | None = None   # host-only config
        # None = auto (device-dependent); "record" | "segment" force a
        # kernel mode — see _plan_device
        self.device_session_mode: str | None = None
        # Deferred close decode (device mode): closing sessions keeps
        # the packed extract as a device value; drain_closed() fetches
        # every pending cycle in ONE stacked transfer per buffer shape
        # (each fetch is a full round trip)
        self.defer_close_decode = False
        self._pending_closes: list[tuple] = []
        # moves of the state to the host engine (the pinned-anchor span
        # bound on device="cpu"; on the card it raises, as a failed
        # launch does)
        self.device_fallbacks = 0
        self.dispatch_observer = None   # callable (family, seconds)
        self.epoch: int | None = None   # device relative-time anchor
        self._closed_wm: int = -1       # wm of the last close cycle
        # ingest-path launch accounting: the session device contract is
        # ONE step (or merge) call and ZERO fetches per micro-batch, plus
        # one extract + one fetch per close cycle (deferred: one fetch
        # per drain and buffer shape) — chip_smoke.py and the tests
        # assert on these
        self.session_stats = {
            "batches": 0, "step_dispatches": 0, "close_cycles": 0,
            "close_dispatches": 0, "close_fetches": 0,
            "peek_dispatches": 0, "remap_dispatches": 0, "grows": 0,
        }
        # late-record drop count (both engines decide lateness on the
        # host mirror), H2D/D2H byte totals, and the device path's host
        # stage seconds: key encode, mirror merge, pack, H2D staging
        self.late_drops = 0
        self.transfer_stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        self.stage_stats = {"key_encode_s": 0.0, "mirror_s": 0.0,
                            "pack_s": 0.0, "h2d_s": 0.0}
        # H2D staging of packed batches: a pinned copy, an async copy on
        # a side stream, an event the step waits on; at most
        # _UPLOAD_SLOTS staging buffers stay referenced
        self._upload_ring: deque = deque()
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        self.dicts: dict[str, StringDictionary] = {
            name: StringDictionary() for name, t in schema.fields
            if t == ColumnType.STRING
        }
        self._code_cols_cache: tuple[int, list[np.ndarray]] = (-1, [])
        # read-plane versioning: bumped at every mutation
        # entry point (ingest, close, engine migration) so equal
        # read_version() tuples guarantee identical peek() results.
        # Plain int — lock-free readers at worst miss spuriously.
        self.read_epoch = 0
        self._read_nonce = next(_READ_NONCE)

    # QueryExecutor._extract_filter reads self.node only.

    def _agg_input(self, agg: AggSpec, row: Mapping[str, Any]):
        if agg.input is None:
            return 1
        try:
            v = eval_host(agg.input, row)
        except (TypeError, KeyError):
            return None
        # non-numeric values are NULL, the same rule the vectorized
        # path's _agg_input_cols applies — lateness must not change
        # whether a malformed record is skipped or crashes the query
        if not isinstance(v, (int, float)):
            return None
        if isinstance(v, float) and not math.isfinite(v):
            return None
        return v

    def _acc_update(self, agg: AggSpec, acc, v):
        if agg.kind == AggKind.COUNT_ALL:
            return acc + 1
        if v is None:
            return acc
        if agg.kind == AggKind.COUNT:
            return acc + 1
        if agg.kind == AggKind.SUM:
            return acc + float(v)
        if agg.kind == AggKind.AVG:
            return (acc[0] + float(v), acc[1] + 1)
        if agg.kind == AggKind.MIN:
            return min(acc, float(v))
        if agg.kind == AggKind.MAX:
            return max(acc, float(v))
        if agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            reg, rank = hll_update_np(np.asarray([float(v)]), self.hll)
            acc = acc.copy()
            acc[reg[0]] = max(acc[reg[0]], rank[0])
            return acc
        if agg.kind == AggKind.APPROX_QUANTILE:
            b = int(quantile_bin_np(np.asarray([float(v)]), self.qcfg)[0])
            acc = acc.copy()
            acc[b] += 1
            return acc
        if agg.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT):
            return _acc_merge(agg, acc, [float(v)])
        raise SQLCodegenError(f"session agg {agg.kind} unsupported")

    # ---- vectorized batch path ---------------------------------------------
    #
    # SURVEY §7's session plan, realized: per-batch segmentation is
    # numpy (lexsort by (key, ts) + gap-break detection), per-SEGMENT
    # accumulators come from reduceat / scattered histogram updates, and
    # only the few segments (<= touched keys x batch span / gap) walk
    # the host merge. Merging a whole segment is exact: within a segment
    # consecutive records are <= gap apart, so sequential per-record
    # processing would land them all in one session chain, and every
    # accumulator is a commutative monoid. Segments that might interact
    # with the late-record policy (any record at ts + gap + grace <= the
    # pre-batch watermark) take the per-record fallback, which preserves
    # the reference's record-at-a-time drop-vs-merge decisions
    # (SessionWindowedStream.hs:84-118).

    def process(self, rows: Sequence[Mapping[str, Any]],
                ts_ms: Sequence[int]) -> list[dict[str, Any]]:
        if not rows:
            return []
        self.read_epoch += 1
        if self._device_ready():
            out = self._process_rows_device(rows, ts_ms)
            if out is not _DEGRADED:
                return out
            # moved to the host engine mid-plan (the span bound, on
            # device="cpu"): device state was pulled back into
            # self.sessions untouched by this batch — fall through to
            # the host engine below
        gap = self.window.gap_ms
        grace = self.window.grace_ms
        touched: set[tuple] = set()
        ts_all = np.asarray(ts_ms, np.int64)
        new_wm = int(ts_all.max())
        ts = ts_all
        if self._filter is not None:
            keep = np.fromiter((self._row_passes(r) for r in rows),
                               np.bool_, len(rows))
            if not keep.all():
                idx = np.nonzero(keep)[0]
                rows = [rows[i] for i in idx.tolist()]
                ts = ts[idx]
        n = len(rows)
        if n:
            codes, key_rev = self._key_codes(rows)
            order = np.lexsort((ts, codes))
            ks = codes[order]
            tss = ts[order]
            brk = np.empty(n, np.bool_)
            brk[0] = True
            brk[1:] = (ks[1:] != ks[:-1]) | ((tss[1:] - tss[:-1]) > gap)
            starts = np.nonzero(brk)[0]
            ends = np.append(starts[1:], n)
            seg_t0 = tss[starts]
            seg_t1 = tss[ends - 1]
            nseg = len(starts)
            wm = self.watermark
            # any record possibly subject to the late policy -> per-row
            slow = (seg_t0 + gap + grace <= wm if wm >= 0
                    else np.zeros(nseg, np.bool_))
            seg_of_row = np.cumsum(brk) - 1
            accs_cols = self._segment_accs(rows, order, starts, ends,
                                           seg_of_row)
            seg_keys = ks[starts]
            for j in range(nseg):
                key = key_rev[int(seg_keys[j])]
                if slow[j]:
                    for i in order[starts[j]:ends[j]].tolist():
                        if self._ingest_row(rows[i], int(ts[i])):
                            touched.add(key)
                    continue
                accs = {a.out_name: accs_cols[a.out_name][j]
                        for a in self.aggs}
                self._merge_segment(key, int(seg_t0[j]), int(seg_t1[j]),
                                    accs)
                touched.add(key)
        if new_wm > self.watermark:
            self.watermark = new_wm

        out = None
        if self.emit_changes:
            pairs = [(key, s) for key in touched
                     for s in self.sessions.get(key, [])]
            out = extend_rows(out, self._emit_cols_batch(pairs))
        # a lone columnar batch (changes or closes) stays columnar all
        # the way to the caller (extend_rows)
        out = extend_rows(out, self.close_due_sessions())
        return out if out is not None else []

    def _row_passes(self, row: Mapping[str, Any]) -> bool:
        try:
            return bool(eval_host(self._filter, row))
        except (TypeError, KeyError):
            return False

    # key-encoding cache bound: codes only matter WITHIN one batch, so
    # the caches are safe to drop wholesale; bounding them keeps a
    # months-long high-cardinality query (session per request_id) from
    # growing without limit after its sessions closed
    _KEY_CACHE_MAX = 1 << 18

    def _bound_key_cache(self) -> None:
        """Cache-bound enforcement: host mode drops the caches wholesale
        (codes only matter within one batch there); device mode must
        keep codes of keys with LIVE arena sessions stable, so it
        compacts through the order-preserving remap kernel instead."""
        if len(self._code_of) <= self._KEY_CACHE_MAX:
            return
        if self._dev is not None:
            self._compact_codes_device()
        else:
            self._code_of = {}
            self._code_rev = []
            self._raw_memo = {}
            self._code_cols_cache = (-1, [])

    def _key_codes(self, rows) -> tuple[np.ndarray, list]:
        """Dense int codes per row's group key. Codes persist across
        batches (encoding cache only — not part of snapshot state);
        raw-value memoization keeps the per-row cost to one dict hit."""
        self._bound_key_cache()
        out = np.empty(len(rows), np.int64)
        rev = self._code_rev
        if len(self.group_cols) == 1:
            c = self.group_cols[0]
            memo = self._raw_memo
            for i, r in enumerate(rows):
                v = r.get(c)
                code = memo.get(v)
                if code is None:
                    k = canon_key((v,))
                    code = self._code_of.get(k)
                    if code is None:
                        code = len(rev)
                        self._code_of[k] = code
                        rev.append(k)
                    memo[v] = code
                out[i] = code
        else:
            cols = self.group_cols
            memo = self._raw_memo
            for i, r in enumerate(rows):
                raw = tuple(r.get(c) for c in cols)
                code = memo.get(raw)
                if code is None:
                    k = canon_key(raw)
                    code = self._code_of.get(k)
                    if code is None:
                        code = len(rev)
                        self._code_of[k] = code
                        rev.append(k)
                    memo[raw] = code
                out[i] = code
        return out, rev

    def _agg_input_cols(self, a: AggSpec, rows,
                        n: int) -> tuple[np.ndarray, np.ndarray]:
        """(values f64[n], valid bool[n]) for one aggregate's input.
        Invalid = missing / None / non-numeric / non-finite (the same
        records _agg_input returns None for)."""
        if a.input is None:  # _agg_input's constant-1 case
            return np.ones(n, np.float64), np.ones(n, np.bool_)
        # one extraction per distinct input column/expr per batch (p50 +
        # p99 over the same column share it)
        ck = (("col", a.input.name) if isinstance(a.input, Col)
              else ("expr", id(a.input)))
        hit = self._input_cache.get(ck)
        if hit is not None:
            return hit
        if isinstance(a.input, Col):
            name = a.input.name
            raw = [r.get(name) for r in rows]
        else:
            raw = []
            for r in rows:
                try:
                    raw.append(eval_host(a.input, r))
                except (TypeError, KeyError):
                    raw.append(None)
        # one NULL rule for both engines: only int/float values count
        # (matching _agg_input's isinstance check on the per-record slow
        # path). A bare float64 asarray would silently coerce NUMERIC
        # STRINGS here while the slow path NULLs them — the same record
        # would then aggregate differently depending on lateness. The
        # dtype probe keeps the all-numeric common case vectorized: any
        # string/None/mixed value forces a non-numeric dtype and takes
        # the per-element rule.
        try:
            arr = np.asarray(raw)
        except (TypeError, ValueError):  # ragged sequences etc.
            arr = None
        if arr is not None and arr.dtype.kind in "fiub":
            vals = arr.astype(np.float64)
        else:
            vals = np.array(
                [float(v) if isinstance(v, (int, float)) else np.nan
                 for v in raw], np.float64)
        res = (vals, np.isfinite(vals))
        self._input_cache[ck] = res
        return res

    def _segment_accs(self, rows, order, starts, ends,
                      seg_of_row) -> dict[str, Any]:
        """Per-segment accumulators (same formats _acc_init/_acc_merge
        use), one vectorized reduction per aggregate."""
        nseg = len(starts)
        out: dict[str, Any] = {}
        seg_len = None
        self._input_cache: dict = {}
        for a in self.aggs:
            if a.kind == AggKind.COUNT_ALL:
                if seg_len is None:
                    seg_len = (ends - starts).astype(np.int64)
                out[a.out_name] = seg_len.tolist()
                continue
            vals, valid = self._agg_input_cols(a, rows, len(order))
            vs = vals[order]
            ok = valid[order]
            if a.kind == AggKind.COUNT:
                out[a.out_name] = np.add.reduceat(
                    ok.astype(np.int64), starts).tolist()
            elif a.kind == AggKind.SUM:
                out[a.out_name] = np.add.reduceat(
                    np.where(ok, vs, 0.0), starts).tolist()
            elif a.kind == AggKind.AVG:
                s = np.add.reduceat(np.where(ok, vs, 0.0), starts)
                c = np.add.reduceat(ok.astype(np.int64), starts)
                out[a.out_name] = list(zip(s.tolist(), c.tolist()))
            elif a.kind == AggKind.MIN:
                out[a.out_name] = np.minimum.reduceat(
                    np.where(ok, vs, np.inf), starts).tolist()
            elif a.kind == AggKind.MAX:
                out[a.out_name] = np.maximum.reduceat(
                    np.where(ok, vs, -np.inf), starts).tolist()
            elif a.kind == AggKind.APPROX_QUANTILE:
                hist = np.zeros((nseg, self.qcfg.n_bins), np.int64)
                b = quantile_bin_np(np.where(ok, vs, self.qcfg.min_value),
                                    self.qcfg)
                np.add.at(hist, (seg_of_row[ok], b[ok]), 1)
                out[a.out_name] = hist
            elif a.kind == AggKind.APPROX_COUNT_DISTINCT:
                regs = np.zeros((nseg, self.hll.m), np.int8)
                reg, rank = hll_update_np(
                    np.where(ok, vs, 0.0).astype(np.float32), self.hll)
                np.maximum.at(regs, (seg_of_row[ok], reg[ok]), rank[ok])
                out[a.out_name] = regs
            elif a.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT):
                k = agg_width(a)
                lst = []
                for j in range(nseg):
                    sv = vs[starts[j]:ends[j]][ok[starts[j]:ends[j]]]
                    if a.kind == AggKind.TOPK_DISTINCT:
                        sv = np.unique(sv)
                    sv = np.sort(sv)[::-1][:k]
                    lst.append([float(x) for x in sv])
                out[a.out_name] = lst
            else:
                raise SQLCodegenError(
                    f"session agg {a.kind} unsupported")
        return out

    def _merge_segment(self, key: tuple, t0: int, t1: int,
                       accs: dict[str, Any]) -> None:
        gap = self.window.gap_ms
        sess_list = self.sessions.setdefault(key, [])
        overl = [s for s in sess_list
                 if s.start - gap <= t1 and t0 <= s.end + gap]
        if not overl:
            # copy array accs: segment rows are views into batch-wide
            # reduction buffers and must not pin them in session state
            own = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                   for k, v in accs.items()}
            sess_list.append(_Session(start=t0, end=t1, accs=own))
            sess_list.sort(key=lambda s: s.start)
            return
        m = overl[0]
        for s in overl[1:]:
            m.start = min(m.start, s.start)
            m.end = max(m.end, s.end)
            for a in self.aggs:
                m.accs[a.out_name] = _acc_merge(
                    a, m.accs[a.out_name], s.accs[a.out_name])
            sess_list.remove(s)
        m.start = min(m.start, t0)
        m.end = max(m.end, t1)
        for a in self.aggs:
            m.accs[a.out_name] = _acc_merge(
                a, m.accs[a.out_name], accs[a.out_name])

    def _ingest_row(self, row: Mapping[str, Any], ts: int) -> bool:
        """Exact per-record path (late-policy segments): returns True
        when the record landed in a session, False when dropped."""
        gap = self.window.gap_ms
        grace = self.window.grace_ms
        key = canon_key(tuple(row.get(c) for c in self.group_cols))
        sess_list = self.sessions.setdefault(key, [])
        overl = [s for s in sess_list
                 if s.start - gap <= ts <= s.end + gap]
        # Late-record policy (reference merge-on-overlap,
        # SessionWindowedStream.hs:84-118): drop only when the record
        # is past grace AND cannot merge into any still-open session.
        if (not overl and self.watermark >= 0
                and ts + gap + grace <= self.watermark):
            self.late_drops += 1
            return False
        if overl:
            merged = overl[0]
            for s in overl[1:]:
                merged.end = max(merged.end, s.end)
                merged.start = min(merged.start, s.start)
                for a in self.aggs:
                    merged.accs[a.out_name] = _acc_merge(
                        a, merged.accs[a.out_name], s.accs[a.out_name])
                sess_list.remove(s)
            merged.start = min(merged.start, ts)
            merged.end = max(merged.end, ts)
            target = merged
        else:
            target = _Session(start=ts, end=ts, accs={
                a.out_name: _acc_init(a, self.hll, self.qcfg)
                for a in self.aggs})
            sess_list.append(target)
            sess_list.sort(key=lambda s: s.start)
        for a in self.aggs:
            target.accs[a.out_name] = self._acc_update(
                a, target.accs[a.out_name],
                self._agg_input(a, row))
        return True

    def close_due_sessions(self) -> list[dict[str, Any]]:
        # A session may only close once no acceptable future record can
        # still merge into it. Acceptable records have ts > wm-gap-grace
        # (the in-grace gate) and merge into s when ts <= s.end + gap, so
        # the session is safe to close when wm >= end + 2*gap + grace.
        # The reference never eagerly deletes session state
        # (SessionWindowedStream.hs:84-118); closing one gap-width later
        # preserves its merge-on-overlap semantics while still emitting.
        self.read_epoch += 1
        if self._dev is not None:
            return self._close_due_device()
        gap, grace = self.window.gap_ms, self.window.grace_ms
        pairs: list[tuple[tuple, _Session]] = []
        for key, sess_list in list(self.sessions.items()):
            due = [s for s in sess_list
                   if s.end + 2 * gap + grace <= self.watermark]
            for s in due:
                if not self.emit_changes:
                    pairs.append((key, s))
                sess_list.remove(s)
            if not sess_list:
                del self.sessions[key]
        return self._emit_cols_batch(pairs)

    def _emit_cols_batch(self, pairs: list
                         ) -> "ColumnarEmit | list[dict[str, Any]]":
        """Columnar emission of many host sessions at once: every
        aggregate finalizes as one vectorized column (sketch estimates
        batched over the whole set), HAVING/projections evaluate
        columnwise, and the result stays a ColumnarEmit until the wire —
        sessions were the last emitter materializing per-row dicts.
        The per-row reference is _emit_row (equivalence tests and the
        host-only-op fallback)."""
        if not pairs:
            return []
        n = len(pairs)
        cols: dict[str, Any] = {}
        for gi, name in enumerate(self.group_cols):
            arr = np.empty(n, object)
            arr[:] = [key[gi] for key, _ in pairs]
            cols[name] = arr
        for a in self.aggs:
            accs = [s.accs[a.out_name] for _, s in pairs]
            if a.kind in (AggKind.COUNT_ALL, AggKind.COUNT):
                cols[a.out_name] = np.asarray(accs, np.int64)
            elif a.kind == AggKind.SUM:
                cols[a.out_name] = np.asarray(accs, np.float64)
            elif a.kind == AggKind.AVG:
                s_ = np.asarray([x[0] for x in accs], np.float64)
                c_ = np.asarray([x[1] for x in accs], np.int64)
                cols[a.out_name] = s_ / np.maximum(c_, 1)
            elif a.kind == AggKind.MIN:
                v = np.asarray(accs, np.float64)
                cols[a.out_name] = np.where(v == np.inf, 0.0, v)
            elif a.kind == AggKind.MAX:
                v = np.asarray(accs, np.float64)
                cols[a.out_name] = np.where(v == -np.inf, 0.0, v)
            elif a.kind == AggKind.APPROX_COUNT_DISTINCT:
                regs = np.stack(accs)
                cols[a.out_name] = np.rint(
                    hll_estimate_np(regs, self.hll)).astype(np.int64)
            elif a.kind == AggKind.APPROX_QUANTILE:
                hist = np.stack(accs)
                cols[a.out_name] = quantile_estimate_np(
                    hist, a.quantile or 0.5, self.qcfg).astype(np.float64)
            elif a.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT):
                arr = np.empty(n, object)
                arr[:] = [list(acc) for acc in accs]
                cols[a.out_name] = arr
            else:
                raise SQLCodegenError(f"session agg {a.kind} unsupported")
        cols["winStart"] = np.asarray([s.start for _, s in pairs],
                                      np.int64)
        cols["winEnd"] = np.asarray(
            [s.end + self.window.gap_ms for _, s in pairs], np.int64)
        return self._postprocess_session_cols(cols, n)

    def _postprocess_session_cols(self, cols: dict[str, Any], n: int
                                  ) -> "ColumnarEmit | list[dict[str, Any]]":
        """HAVING + SELECT projections over a columnar session batch;
        any host-only op (or NULL-driven eval error) falls back to the
        per-row path whose drop semantics match _emit_row exactly."""
        if self.node.having is not None:
            try:
                keep = np.broadcast_to(
                    np.asarray(eval_host_vec(self.node.having, cols),
                               np.bool_), (n,))
            except Exception:  # noqa: BLE001 — host-only op / NULLs
                return self._postprocess_session_rows(
                    ColumnarEmit(cols, n))
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
                    projected[meta] = cols[meta]
                cols = projected
            except Exception:  # noqa: BLE001
                return self._postprocess_session_rows(
                    ColumnarEmit(cols, n))
        return ColumnarEmit(cols, n)

    def _postprocess_session_rows(self, rows) -> list[dict[str, Any]]:
        """Per-row HAVING/projection fallback — the same drop rules as
        _emit_row (a HAVING eval error drops the row; projection errors
        propagate, as they always did)."""
        out = []
        for row in rows:
            if self.node.having is not None:
                try:
                    if not eval_host(self.node.having, row):
                        continue
                except (TypeError, KeyError):
                    continue
            if self.node.post_projections:
                proj = {}
                for name, expr in self.node.post_projections:
                    proj[name] = eval_host(expr, row)
                for meta in ("winStart", "winEnd"):
                    proj[meta] = row[meta]
                out.append(proj)
            else:
                out.append(row)
        return out

    def _finalize(self, agg: AggSpec, acc):
        if agg.kind == AggKind.AVG:
            return acc[0] / max(acc[1], 1)
        if agg.kind == AggKind.MIN:
            return 0.0 if acc == math.inf else acc
        if agg.kind == AggKind.MAX:
            return 0.0 if acc == -math.inf else acc
        if agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            return int(np.rint(hll_estimate_np(acc, self.hll)))
        if agg.kind == AggKind.APPROX_QUANTILE:
            return float(quantile_estimate_np(acc, agg.quantile or 0.5,
                                              self.qcfg))
        if agg.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT):
            return list(acc)
        return acc

    def _emit_row(self, key: tuple, s: _Session,
                  overrides: dict[str, Any] | None = None
                  ) -> dict[str, Any] | None:
        """One emitted row. `overrides` carries pre-finalized aggregate
        values (the batched sketch finalization) so the close path and
        this path share the HAVING/projection/window-stamp tail."""
        row = dict(zip(self.group_cols, key))
        for a in self.aggs:
            if overrides is not None and a.out_name in overrides:
                row[a.out_name] = overrides[a.out_name]
            else:
                row[a.out_name] = self._finalize(a, s.accs[a.out_name])
        row["winStart"] = s.start
        row["winEnd"] = s.end + self.window.gap_ms
        if self.node.having is not None:
            try:
                if not eval_host(self.node.having, row):
                    return None
            except (TypeError, KeyError):
                return None
        if self.node.post_projections:
            proj = {}
            for name, expr in self.node.post_projections:
                proj[name] = eval_host(expr, row)
            for meta in ("winStart", "winEnd"):
                proj[meta] = row[meta]
            return proj
        return row

    def peek(self) -> list[dict[str, Any]]:
        """Open-session rows (pull queries / view peeks), columnar on
        both engines: ONE read-only extract dispatch + ONE fetch covers
        every open session on device; the host engine finalizes every
        session as one vectorized column batch."""
        if self._dev is not None:
            return self._peek_device()
        pairs = [(key, s) for key, sess_list in self.sessions.items()
                 for s in sess_list]
        return self._emit_cols_batch(pairs)

    # contract: dispatches<=0 fetches<=0
    def read_version(self) -> tuple:
        """Exact version of the peek-visible session set (the read
        cache's validity key): equal tuples guarantee peek()
        would return the same rows. Host ints only, lock-free safe."""
        return ("sess", self._read_nonce, self.read_epoch,
                self.session_stats["close_cycles"], self.watermark)

    # contract: dispatches<=0 fetches<=0
    def live_min_win_end(self) -> int | None:
        """Smallest winEnd any open session could emit (session winEnd
        is end + gap), or None when no session is open — read off the
        host dict or the device interval mirror, never the arena
        (closed-only readers skip peek() entirely)."""
        gap = self.window.gap_ms
        if self._dev is not None:
            dev = self._dev
            live = dev["mir_live"]
            if not live.any():
                return None
            return int(dev["mir_t1"][live].min()) + gap
        ends = [s.end for sess_list in self.sessions.values()
                for s in sess_list]
        if not ends:
            return None
        return min(ends) + gap

    # ---- device session path (engine/session_lattice.py kernels) -----------
    #
    # Open sessions live in a device arena sorted by (code, t0); each
    # micro-batch is ONE step (or merge) wrapper call and ZERO fetches;
    # close cycles and peeks are one pow2-padded extract launch + one
    # fetch each. The host keeps an exact interval mirror
    # (merge_chains_np — the numpy twin of the kernels' scan) that
    # decides late-record drops, close sets, capacity, and slot indices
    # with no device sync. The host engine above is the equivalence
    # reference.

    def _device_ready(self) -> bool:
        if self._dev is not None:
            return True
        if not self.use_device_sessions \
                or self._device_refusal is not None:
            return False
        plan = self._plan_device()
        if plan is None:
            return False  # host-only config: a refusal, not a failure
        if FAULTS.active:  # chaos: provoke an activation failure
            FAULTS.point("device.session.activate")
        self._activate_device(plan)  # a failure raises
        return True

    def _plan_device(self) -> dict | None:
        """Static plan for the device path, or None (with the refusal
        recorded) for host-only configs: EMIT CHANGES sessions (emit
        per touched key, a per-batch extract the host path serves
        better), TOPK list aggregates, and — in record mode — aggregate
        inputs the device expression compiler cannot express.

        Mode selection: "record" packs raw records and runs the session
        step kernel (sort + scan + fold + scatter) — the shape for the
        card, where per-record scatters are cheap. "segment"
        pre-reduces rows into per-segment plane contributions on the
        host (the reference path's vectorized reduceat/add.at) and
        merges arenas — the shape for device="cpu", where per-record
        scatters lose to numpy's vectorized reduction.
        `device_session_mode` overrides."""
        if self.emit_changes:
            self._device_refusal = "EMIT CHANGES sessions emit per " \
                "touched key; host path retained"
            return None
        if 2 * self.window.gap_ms + self.window.grace_ms >= (1 << 30):
            # the close rule (t1 + 2*gap + grace) must fit the int32
            # relative-time budget alongside the span bound
            self._device_refusal = "gap/grace span exceeds the device " \
                "relative-time range; host path retained"
            return None
        for a in self.aggs:
            if a.kind not in self._DEVICE_AGG_KINDS:
                self._device_refusal = \
                    f"aggregate {a.kind.value} is host-only"
                return None
        mode = self.device_session_mode or (
            "segment" if self.device.type == "cpu" else "record")
        try:
            encoded = []
            for a in self.aggs:
                if a.input is not None:
                    a = AggSpec(kind=a.kind, out_name=a.out_name,
                                input=encode_strings(a.input, self.schema,
                                                     self.dicts),
                                quantile=a.quantile, k=a.k)
                encoded.append(a)
            needed: set[str] = set()
            for a in encoded:
                if a.input is not None:
                    needed |= columns_of(a.input)
            layout = tuple(
                (name, sl.layout_tag(self.schema.type_of(name)))
                for name in sorted(needed))
            spec = sl.SessionSpec(aggs=tuple(encoded), hll=self.hll,
                                  qcfg=self.qcfg)
            progs = (sl.session_programs(spec, self.schema)
                     if mode == "record" else ())  # may raise
        except SQLCodegenError as e:  # the device compiler's refusal
            if self.device.type == "cuda":
                if isinstance(e, NotPortedError):
                    raise
                raise NotPortedError(
                    f"a session aggregate input the device compiler "
                    f"refuses ({e}) on the card", "A7c") from e
            self._device_refusal = f"device compile refused: {e}"
            return None
        null_refs = [sorted(columns_of(a.input)) for a in encoded
                     if a.input is not None]
        return {"spec": spec, "layout": layout, "null_refs": null_refs,
                "mode": mode, "progs": progs}

    def _activate_device(self, plan: dict) -> None:
        """Migrate the host session state into a fresh device arena
        (sorted by (code, t0)) and build the interval mirror. The host
        dict is cleared only after every plane uploaded."""
        spec = plan["spec"]
        entries: list[tuple[int, _Session]] = []
        for key, sess_list in self.sessions.items():
            code = self._code_for(key)
            for s in sess_list:
                entries.append((code, s))
        n = len(entries)
        cap = round_up_pow2(2 * max(n, 1), lo=256)
        mir_code = np.empty(n, np.int64)
        mir_t0 = np.empty(n, np.int64)
        mir_t1 = np.empty(n, np.int64)
        for i, (code, s) in enumerate(entries):
            mir_code[i] = code
            mir_t0[i] = s.start
            mir_t1[i] = s.end
        order = np.lexsort((mir_t1, mir_t0, mir_code))
        mir_code, mir_t0, mir_t1 = (mir_code[order], mir_t0[order],
                                    mir_t1[order])
        epoch = int(mir_t0.min()) if n else None
        ssl = None
        if self.mesh is not None and self.mesh.shape["key"] > 1:
            from hstream_tpu_torch.parallel.lattice import \
                ShardedSessionLattice
            ssl = ShardedSessionLattice(self.mesh, spec)
        arena_np = sl.session_plane_np(spec, cap)
        if ssl is not None:
            # per-shard planes: each key shard holds its residue class
            # (code mod n_shards) in mirror order. The per-shard cap keeps
            # the single-card formula: memory spent on skew tolerance.
            arena_np = {k: np.broadcast_to(
                v[None], (ssl.n_shards,) + v.shape).copy()
                for k, v in arena_np.items()}
            cls = (mir_code % ssl.n_shards).astype(np.int64)
            slot = np.empty(n, np.int64)
            for sh in range(ssl.n_shards):
                m = cls == sh
                slot[m] = np.arange(int(m.sum()))

        def dst(j):
            return (cls[j], slot[j]) if ssl is not None else j

        if n:
            if ssl is not None:
                arena_np["code"][cls, slot] = mir_code.astype(np.int32)
                arena_np["t0"][cls, slot] = (mir_t0 - epoch).astype(np.int32)
                arena_np["t1"][cls, slot] = (mir_t1 - epoch).astype(np.int32)
            else:
                arena_np["code"][:n] = mir_code.astype(np.int32)
                arena_np["t0"][:n] = (mir_t0 - epoch).astype(np.int32)
                arena_np["t1"][:n] = (mir_t1 - epoch).astype(np.int32)
            for name, a in zip(sl.session_plane_names(spec), spec.aggs):
                for j, (_code, s) in enumerate(
                        (entries[o] for o in order.tolist())):
                    acc = s.accs[a.out_name]
                    if a.kind == AggKind.AVG:
                        arena_np[name][dst(j)] = np.float32(acc[0])
                        arena_np[name + "_n"][dst(j)] = acc[1]
                    elif a.kind == AggKind.APPROX_COUNT_DISTINCT:
                        arena_np[name][dst(j)] = acc
                    elif a.kind == AggKind.APPROX_QUANTILE:
                        if int(np.max(acc, initial=0)) >= (1 << 31):
                            raise SQLCodegenError(
                                "session histogram count exceeds int32 "
                                "at device activation")
                        arena_np[name][dst(j)] = acc.astype(np.int32)
                    else:
                        arena_np[name][dst(j)] = np.float32(acc) \
                            if arena_np[name].dtype == np.float32 else acc
        self._dev = {
            "spec": spec,
            "layout": plan["layout"],
            "null_refs": plan["null_refs"],
            "mode": plan["mode"],
            "progs": plan["progs"],
            "cap": cap,
            "ssl": ssl,
            "arena": (ssl.put_arena(arena_np) if ssl is not None else
                      {k: torch.from_numpy(v).to(self.device)
                       for k, v in arena_np.items()}),
            # the other arena of the ping-pong: each step writes it
            "spare": (ssl.init_arena(cap) if ssl is not None else
                      sl.init_session_arena(spec, cap, self.device)),
            "mir_code": mir_code,
            "mir_t0": mir_t0,
            "mir_t1": mir_t1,
            "mir_live": np.ones(n, np.bool_),
        }
        self.epoch = epoch
        self.sessions = {}
        self.read_epoch += 1

    def _degrade_to_host(self, reason: str) -> None:
        """Pull the device state back into the host session dict and pin
        this executor to the reference engine — identical results, only
        slower (counted in device_fallbacks). Taken for the pinned-anchor
        span bound on device="cpu" only."""
        log.warning("device session path moving to host: %s", reason)
        # deferred closes decode lazily through _code_rev; the host-mode
        # cache bound may rebuild that dictionary, so resolve their key
        # columns against the CURRENT one now (same rule as the
        # code-space compaction)
        self._resolve_pending_keys()
        self.sessions = self._host_sessions_view()
        self._dev = None
        self.use_device_sessions = False
        self.device_fallbacks += 1
        self.read_epoch += 1

    def _resolve_pending_keys(self) -> None:
        self._pending_closes = [
            (codes, t0, t1, packed,
             keys if keys is not None else
             [arr[codes.astype(np.int64)]
              for arr in self._code_rev_columns()])
            for codes, t0, t1, packed, keys in self._pending_closes]

    # contract: dispatches<=0 fetches<=1
    def _host_sessions_view(self) -> dict[tuple, list[_Session]]:
        """Host-format view of the device arena (state carry-over and the
        move to the host engine): one fetch per plane, then per-live-slot
        acc decode into the reference accumulator formats."""
        dev = self._dev
        if dev.get("ssl") is not None:
            # every mirror row's value out of its shard's plane: the
            # gathered view indexes by mirror row, as the single-card
            # arena does
            cls, slot = self._shard_slots()
            host = {k: np.stack([a[k].cpu().numpy() for a in dev["arena"]])
                    [cls, slot] for k in dev["arena"][0]}
        else:
            host = {k: v.cpu().numpy() for k, v in dev["arena"].items()}
        spec = dev["spec"]
        sessions: dict[tuple, list[_Session]] = {}
        for slot in np.nonzero(dev["mir_live"])[0].tolist():
            key = self._code_rev[int(dev["mir_code"][slot])]
            accs: dict[str, Any] = {}
            for name, a in zip(sl.session_plane_names(spec), spec.aggs):
                v = host[name][slot]
                if a.kind in (AggKind.COUNT_ALL, AggKind.COUNT):
                    accs[a.out_name] = int(v)
                elif a.kind == AggKind.SUM:
                    accs[a.out_name] = float(v)
                elif a.kind == AggKind.AVG:
                    accs[a.out_name] = (float(v),
                                        int(host[name + "_n"][slot]))
                elif a.kind in (AggKind.MIN, AggKind.MAX):
                    accs[a.out_name] = float(v)
                elif a.kind == AggKind.APPROX_COUNT_DISTINCT:
                    accs[a.out_name] = np.asarray(v, np.int8).copy()
                elif a.kind == AggKind.APPROX_QUANTILE:
                    accs[a.out_name] = np.asarray(v, np.int64).copy()
            sessions.setdefault(key, []).append(_Session(
                start=int(dev["mir_t0"][slot]),
                end=int(dev["mir_t1"][slot]), accs=accs))
        return sessions

    def _shard_slots(self) -> tuple[np.ndarray, np.ndarray]:
        """(key shard, per-shard arena slot) of every mirror row: each
        shard's arena holds exactly its residue class's chains in mirror
        order, so a row's slot is its rank within its class. Dead rows
        (mir_live False) still occupy arena slots until the next step
        retires them, so the ranks run over ALL rows; a dead row's code
        after a compaction is negative with its class kept (numpy's floor
        modulo)."""
        dev = self._dev
        ns = dev["ssl"].n_shards
        cls = (dev["mir_code"] % ns).astype(np.int64)
        slot = np.empty(len(cls), np.int64)
        for s in range(ns):
            m = cls == s
            slot[m] = np.arange(int(m.sum()))
        return cls, slot

    def _process_rows_device(self, rows, ts_ms):
        """Row-shaped ingest onto the device path: host filter eval,
        key-code encode, then either schema-typed columns (record mode)
        or per-aggregate value columns (segment mode)."""
        ts_all = np.asarray(ts_ms, np.int64)
        pre_max = int(ts_all.max())
        ts = ts_all
        if self._filter is not None:
            keepf = np.fromiter((self._row_passes(r) for r in rows),
                                np.bool_, len(rows))
            if not keepf.all():
                idx = np.nonzero(keepf)[0]
                rows = [rows[i] for i in idx.tolist()]
                ts = ts[idx]
        if not rows:
            return self._advance_and_close_device(pre_max)
        t0 = time.perf_counter()
        codes, _rev = self._key_codes(rows)
        self.stage_stats["key_encode_s"] += time.perf_counter() - t0
        if self._dev["mode"] == "record":
            batch = HostBatch.from_rows(self.schema, rows, ts, self.dicts)
            feed = ("record", batch.cols, batch.nulls)
        else:
            self._input_cache = {}
            feed = ("segment", [
                None if a.input is None
                else self._agg_input_cols(a, rows, len(rows))
                for a in self.aggs])
        return self._process_device(codes.astype(np.int64), ts, feed,
                                    pre_max)

    def process_columnar(self, ts_ms, cols: Mapping[str, Any],
                         nulls: Mapping[str, np.ndarray] | None = None
                         ) -> list[dict[str, Any]]:
        """Columnar session ingest: int64 absolute-ms timestamps plus
        named numpy columns (object or unicode arrays for strings); a
        null-mask cell means the field is ABSENT from that record. On
        the device path the batch packs straight from the arrays
        (vectorized key encode, no row dicts); until the device path
        activates — or on the host engine — rows materialize once and
        take the row path, so semantics are identical."""
        n = len(ts_ms)
        if n == 0:
            return []
        self.read_epoch += 1
        if self._device_ready():
            out = self._process_columnar_device(
                np.asarray(ts_ms, np.int64), cols, nulls)
            if out is not _DEGRADED:
                return out
        return self.process(self._rows_from_cols(cols, nulls, n),
                            [int(t) for t in np.asarray(ts_ms)])

    @staticmethod
    def _rows_from_cols(cols, nulls, n: int) -> list[dict[str, Any]]:
        """Materialize columnar input into per-row dicts (pre-activation
        / host-engine path); null-masked cells are ABSENT fields, the
        per-record decode shape."""
        names = list(cols)
        lists = [np.asarray(cols[c]).tolist() for c in names]
        rows = [dict(zip(names, vals)) for vals in zip(*lists)] \
            if names else [{} for _ in range(n)]
        if nulls:
            for cname, mask in nulls.items():
                if cname not in cols:
                    continue
                for row, isnull in zip(rows, np.asarray(mask).tolist()):
                    if isnull:
                        del row[cname]
        return rows

    def _process_columnar_device(self, ts, cols, nulls):
        """Columnar twin of _process_rows_device: vectorized host
        filter, memoized key encode, schema-typed device columns."""
        n = len(ts)
        pre_max = int(ts.max())
        kept = None
        if self._filter is not None:
            try:
                fv = eval_host_vec(self._filter, cols)
                keep = np.broadcast_to(np.asarray(fv, np.bool_),
                                       (n,)).copy()
            except Exception:  # noqa: BLE001 — host-only op in WHERE:
                # materialize rows once, run the row-shaped device path
                return self._process_rows_device(
                    self._rows_from_cols(cols, nulls, n),
                    [int(t) for t in ts])
            if nulls:
                # SQL NULL in a WHERE operand: predicate not-true
                for c in columns_of(self._filter):
                    nm = nulls.get(c)
                    if nm is not None:
                        keep &= ~np.asarray(nm, np.bool_)
            if not keep.all():
                kept = np.nonzero(keep)[0]
                ts = ts[kept]
                if len(ts) == 0:
                    return self._advance_and_close_device(pre_max)
        nk = n if kept is None else len(kept)
        t0 = time.perf_counter()
        codes = self._key_codes_cols(cols, nulls, kept, nk)
        self.stage_stats["key_encode_s"] += time.perf_counter() - t0
        if self._dev["mode"] == "record":
            dcols, dnulls = self._typed_cols(cols, nulls, kept, nk)
            feed = ("record", dcols, dnulls)
        else:
            feed = ("segment", self._agg_vals_cols(cols, nulls, kept, nk))
        return self._process_device(codes, ts, feed, pre_max)

    def _agg_vals_cols(self, cols, nulls, kept, n: int):
        """(values f64[n], valid bool[n]) per aggregate straight from
        raw columnar input — the columnar twin of _agg_input_cols, same
        NULL rules (None / non-numeric / non-finite / null-masked cells
        do not contribute)."""
        out: list[tuple[np.ndarray, np.ndarray] | None] = []
        cache: dict = {}
        rows_cache: list | None = None
        for a in self.aggs:
            if a.input is None:
                out.append(None)
                continue
            ck = (("col", a.input.name) if isinstance(a.input, Col)
                  else ("expr", id(a.input)))
            hit = cache.get(ck)
            if hit is None:
                if isinstance(a.input, Col):
                    raw = cols.get(a.input.name)
                    if raw is None:
                        vals = np.full(n, np.nan)
                    else:
                        arr = np.asarray(raw)
                        if kept is not None:
                            arr = arr[kept]
                        if arr.dtype.kind in "fiub":
                            vals = arr.astype(np.float64)
                        else:
                            vals = np.array(
                                [float(v) if isinstance(v, (int, float))
                                 else np.nan for v in arr.tolist()],
                                np.float64)
                else:
                    try:
                        v = eval_host_vec(a.input, cols)
                        vals = (np.full(n, float(v)) if np.ndim(v) == 0
                                else np.asarray(v, np.float64))
                        if kept is not None and len(vals) != n:
                            vals = vals[kept]
                    except Exception:  # noqa: BLE001 — host-only op:
                        # per-row eval over materialized dicts, once
                        if rows_cache is None:
                            rows_cache = self._rows_from_cols(
                                cols, nulls, len(np.asarray(
                                    next(iter(cols.values())))))
                            if kept is not None:
                                rows_cache = [rows_cache[i]
                                              for i in kept.tolist()]
                        vals = np.empty(n, np.float64)
                        for i, r in enumerate(rows_cache):
                            try:
                                v = eval_host(a.input, r)
                            except (TypeError, KeyError):
                                v = None
                            vals[i] = (float(v) if isinstance(
                                v, (int, float)) else np.nan)
                # null-masked referenced cells do not contribute
                if nulls:
                    for c in columns_of(a.input):
                        nm = nulls.get(c)
                        if nm is not None:
                            nm = np.asarray(nm, np.bool_)
                            vals = vals.copy()
                            vals[nm[kept] if kept is not None
                                 else nm] = np.nan
                hit = (vals, np.isfinite(vals))
                cache[ck] = hit
            out.append(hit)
        return out

    def _key_codes_cols(self, cols, nulls, kept, n: int) -> np.ndarray:
        """Dense key codes from columnar input. Numpy-typed columns
        factorize at C speed (np.unique per column, one dict hit per
        DISTINCT value/combination — the _columnar_key_ids discipline);
        object columns fall back to the memoized per-row loop.
        Null-masked group cells decode as None."""
        self._bound_key_cache()
        if not self.group_cols:  # global session: one key ()
            k = canon_key(())
            code = self._code_of.get(k)
            if code is None:
                code = len(self._code_rev)
                self._code_of[k] = code
                self._code_rev.append(k)
            return np.full(n, code, np.int64)
        col_vals: list[list] = []
        col_codes: list[np.ndarray] = []
        for cname in self.group_cols:
            arr = cols.get(cname)
            if arr is None:
                col_vals.append([None])
                col_codes.append(np.zeros(n, np.int64))
                continue
            a = np.asarray(arr)
            if kept is not None:
                a = a[kept]
            nm = nulls.get(cname) if nulls else None
            if nm is not None:
                nm = np.asarray(nm, np.bool_)
                if kept is not None:
                    nm = nm[kept]
                if not nm.any():
                    nm = None
            if a.dtype.kind == "O":
                return self._key_codes_cols_slow(cols, nulls, kept, n)
            uniq, inv = np.unique(a, return_inverse=True)
            vals = uniq.tolist()  # python scalars: canon/dict semantics
            codes = inv.astype(np.int64)
            if nm is not None:
                vals = [None] + vals
                codes = np.where(nm, 0, codes + 1)
            col_vals.append(vals)
            col_codes.append(codes)
        if len(col_vals) == 1:
            vals, codes = col_vals[0], col_codes[0]
            lut = np.empty(len(vals), np.int64)
            for p, v in enumerate(vals):
                lut[p] = self._code_for(canon_key((v,)))
            return lut[codes]
        radix = 1
        for vals in col_vals:
            radix *= max(len(vals), 1)
        if radix >= (1 << 62):  # mixed-radix would overflow int64
            return self._key_codes_cols_slow(cols, nulls, kept, n)
        combined = col_codes[0]
        for codes, vals in zip(col_codes[1:], col_vals[1:]):
            combined = combined * len(vals) + codes
        u, inv = np.unique(combined, return_inverse=True)
        lut = np.empty(len(u), np.int64)
        for j, cu in enumerate(u.tolist()):
            idxs = []
            for vals in reversed(col_vals[1:]):
                idxs.append(cu % len(vals))
                cu //= len(vals)
            idxs.append(cu)
            idxs.reverse()
            key = canon_key(tuple(col_vals[g][i]
                                  for g, i in enumerate(idxs)))
            lut[j] = self._code_for(key)
        return lut[inv]

    def _code_for(self, key: tuple) -> int:
        code = self._code_of.get(key)
        if code is None:
            code = len(self._code_rev)
            self._code_of[key] = code
            self._code_rev.append(key)
        return code

    def _key_codes_cols_slow(self, cols, nulls, kept, n: int
                             ) -> np.ndarray:
        """Object-column fallback: one memoized dict hit per row over
        raw value tuples (the _key_codes discipline)."""
        parts: list[list] = []
        for cname in self.group_cols:
            arr = cols.get(cname)
            if arr is None:
                parts.append([None] * n)
                continue
            a = np.asarray(arr)
            if kept is not None:
                a = a[kept]
            vals = a.tolist()
            nm = nulls.get(cname) if nulls else None
            if nm is not None:
                nm = np.asarray(nm, np.bool_)
                if kept is not None:
                    nm = nm[kept]
                if nm.any():
                    vals = [None if isnull else v
                            for v, isnull in zip(vals, nm.tolist())]
            parts.append(vals)
        memo = self._raw_memo
        out = np.empty(n, np.int64)
        rows_iter = zip(*parts) if len(parts) > 1 \
            else ((v,) for v in parts[0])
        for i, raw in enumerate(rows_iter):
            code = memo.get(raw)
            if code is None:
                code = self._code_for(canon_key(raw))
                memo[raw] = code
            out[i] = code
        return out

    def _typed_cols(self, cols, nulls, kept, n: int):
        """Schema-typed device columns + per-column null masks from raw
        columnar input — the same NULL rules as HostBatch.from_rows
        (None / non-scalar numeric cells are SQL NULL; strings stringify
        and dictionary-encode)."""
        dcols: dict[str, np.ndarray] = {}
        dnulls: dict[str, np.ndarray] = {}
        for name, _tag in self._dev["layout"]:
            want = self.schema.type_of(name)
            raw = cols.get(name)
            msk = np.zeros(n, np.bool_)
            nm = nulls.get(name) if nulls else None
            if nm is not None:
                nm = np.asarray(nm, np.bool_)
                msk |= nm[kept] if kept is not None else nm
            if raw is None:
                dcols[name] = np.zeros(
                    n, np.int32 if want == ColumnType.STRING
                    else np.float32)
                dnulls[name] = np.ones(n, np.bool_)
                continue
            a = np.asarray(raw)
            if kept is not None:
                a = a[kept]
            if want == ColumnType.STRING:
                enc = self.dicts[name].encode
                out = np.empty(n, np.int32)
                for i, v in enumerate(a.tolist()):
                    if v is None:
                        out[i] = -1
                        msk[i] = True
                    else:
                        out[i] = enc(str(v))
            else:
                dt = (np.bool_ if want == ColumnType.BOOL
                      else np.int32 if want == ColumnType.INT
                      else np.float32)
                if a.dtype.kind in "fiub":
                    out = a.astype(dt)
                else:
                    out = np.zeros(n, dt)
                    for i, v in enumerate(a.tolist()):
                        if v is None or not isinstance(
                                v, (int, float, bool)):
                            msk[i] = True
                        else:
                            out[i] = v
            dcols[name] = out
            if msk.any():
                dnulls[name] = msk
        return dcols, (dnulls or None)

    def _advance_and_close_device(self, pre_max: int):
        """Watermark advance + close cycle for a batch whose records all
        filtered out — the wm still moves (it is computed pre-filter)."""
        if pre_max > self.watermark:
            self.watermark = pre_max
        out = self._close_due_device()
        return out if out else []


    # contract: dispatches<=1 fetches<=0
    def _process_device(self, codes, ts, feed, pre_max):
        """One device micro-batch: mirror-side late walk + segmentation
        + chain merge (numpy), then ONE step (or merge) wrapper call and
        NO fetch — the session ingest contract. Closes ride
        _close_due_device (their own one-launch-one-fetch budget)."""
        dev = self._dev
        gap = self.window.gap_ms
        grace = self.window.grace_ms
        n = len(codes)
        late = 0  # counted once the step launched (a failed one drops none)
        t_mirror = time.perf_counter()
        if n and self.watermark >= 0 \
                and int(ts.min()) + gap + grace <= self.watermark:
            keep = self._late_keep_mask(codes, ts)
            if not keep.all():
                late = int(n - keep.sum())
                idx = np.nonzero(keep)[0]
                codes = codes[idx]
                ts = ts[idx]
                feed = self._subset_feed(feed, idx)
                n = len(codes)
        if n:
            # shared segmentation: per-key gap-chains of this batch —
            # ONE combined-key argsort (codes are < 2^22 and the span is
            # int32-bounded, so code*span+ts fits int64; ties are
            # commutative-merge-equal, so stability is not needed)
            tmin = int(ts.min())
            span = int(ts.max()) - tmin + 1
            order = np.argsort(codes * span + (ts - tmin))
            ks = codes[order]
            tss = ts[order]
            brk = np.empty(n, np.bool_)
            brk[0] = True
            brk[1:] = (ks[1:] != ks[:-1]) | ((tss[1:] - tss[:-1]) > gap)
            starts = np.nonzero(brk)[0]
            ends = np.append(starts[1:], n)
            seg_code = ks[starts]
            seg_t0 = tss[starts]
            seg_t1 = tss[ends - 1]
            live = dev["mir_live"]
            mcode, mt0, mt1 = merge_chains_np(
                np.concatenate([dev["mir_code"][live], seg_code]),
                np.concatenate([dev["mir_t0"][live], seg_t0]),
                np.concatenate([dev["mir_t1"][live], seg_t1]), gap)
            mirror_s = time.perf_counter() - t_mirror
            if FAULTS.active:  # chaos: fail/delay a session step; it
                # raises before the arena grows or the epoch moves
                FAULTS.point("device.session.dispatch")
            # the epoch moves, and the stats count, only once the step
            # has launched: the rebase's shift of the arena's times rides
            # that launch, so a failed one must leave the old epoch
            epoch = int(mt0.min()) if self.epoch is None else self.epoch
            # close_cut is compared against PRE-shift arena times in the
            # kernel, so compute it in the OLD epoch before any rebase.
            # In range by construction: |closed_wm - epoch| < the span
            # bound below and 2*gap + grace < 2^30 (activation guard).
            close_cut = -(1 << 30) if self._closed_wm < 0 else \
                int(self._closed_wm - 2 * gap - grace - epoch)
            delta = self._rebase_delta(epoch, int(mt1.max()),
                                       int(mt0.min()))
            epoch += delta
            if int(mt1.max()) - epoch >= self.REBASE_THRESHOLD:
                # the rebase could not reclaim range (an ancient session
                # pins the anchor): past this bound the kernels' scan
                # arithmetic and the t0 identity stop covering the
                # values. On the card that raises (state on the card
                # never moves to the host engine); on the CPU the HOST
                # engine, which has no such bound, takes over as in the
                # reference instead of desyncing the mirror
                if self.device.type == "cuda":
                    raise NotPortedError(
                        "a session stream span past the device's int32 "
                        "relative-time range while an old session pins "
                        "the epoch", "A7c")
                self.session_stats["batches"] += 1
                self._degrade_to_host(
                    "relative stream span reached the device range "
                    "(an old session is still open); host engine "
                    "continues without the int32 bound")
                return _DEGRADED
            need = len(mcode)
            ssl = dev.get("ssl")
            if ssl is not None:
                # per-shard cap: size to the fullest residue class
                need = int(np.bincount(
                    (mcode % ssl.n_shards).astype(np.int64),
                    minlength=ssl.n_shards).max())
            if need > dev["cap"]:
                self._grow_arena(need)
            if dev["mode"] == "record":
                self._dispatch_record_step(codes, ts, feed, close_cut,
                                           epoch, delta)
            else:
                self._dispatch_segment_merge(
                    feed, order, starts, ends, np.cumsum(brk) - 1,
                    seg_code, seg_t0, seg_t1, close_cut, epoch, delta)
            self.epoch = epoch
            self.stage_stats["mirror_s"] += mirror_s
            self.session_stats["step_dispatches"] += 1
            dev["mir_code"] = mcode
            dev["mir_t0"] = mt0
            dev["mir_t1"] = mt1
            dev["mir_live"] = np.ones(len(mcode), np.bool_)
        self.session_stats["batches"] += 1
        self.late_drops += late
        return self._advance_and_close_device(pre_max)

    @staticmethod
    def _subset_feed(feed, idx):
        """Apply a keep-index to either feed shape (late-record drops)."""
        if feed[0] == "record":
            _tag, cols, nulls = feed
            return ("record",
                    {k: np.asarray(v)[idx] for k, v in cols.items()},
                    None if nulls is None else
                    {k: np.asarray(v)[idx] for k, v in nulls.items()})
        _tag, vv = feed
        return ("segment", [
            None if e is None else (e[0][idx], e[1][idx]) for e in vv])

    def _swap_arenas(self) -> None:
        dev = self._dev
        dev["arena"], dev["spare"] = dev["spare"], dev["arena"]

    def _stage_packed(self, shape: tuple[int, int]):
        """(host int32 array to pack into, its upload): on the card a
        pinned buffer, uploaded by `upload()` on the side stream with an
        event the current stream waits on; at most _UPLOAD_SLOTS staging
        buffers stay referenced. On the CPU the array is the tensor's."""
        if self._copy_stream is None:
            host = torch.empty(shape, dtype=torch.int32)
            return host.numpy(), lambda: host
        pinned = torch.empty(shape, dtype=torch.int32, pin_memory=True)

        def upload() -> torch.Tensor:
            with torch.cuda.stream(self._copy_stream):
                dev = torch.empty(shape, dtype=torch.int32,
                                  device=self.device)
                dev.copy_(pinned, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
            torch.cuda.current_stream(self.device).wait_event(ready)
            # the step reads `dev` on the current stream: tell the
            # caching allocator, so the buffer is not reused early
            dev.record_stream(torch.cuda.current_stream(self.device))
            self._upload_ring.append((ready, pinned))
            while len(self._upload_ring) > _UPLOAD_SLOTS:
                self._upload_ring.popleft()[0].synchronize()
            return dev

        return pinned.numpy(), upload

    def _dispatch_record_step(self, codes, ts, feed, close_cut, epoch,
                              delta):
        """Record-mode step: pack raw records into one int32 buffer
        (times relative to `epoch`, the one after the rebase by `delta`),
        upload it, evaluate computed inputs, and run the session step
        kernel into the spare arena; the arenas then swap."""
        dev = self._dev
        _tag, cols, nulls = feed
        n = len(codes)
        t0 = time.perf_counter()
        ts_rel = (ts - epoch).astype(np.int64)
        null_masks = []
        for refs in dev["null_refs"]:
            m = np.zeros(n, np.bool_)
            if nulls:
                for c in refs:
                    nm = nulls.get(c)
                    if nm is not None:
                        m |= np.asarray(nm, np.bool_)[:n]
            null_masks.append(m if m.any() else None)
        host, upload = self._stage_packed((3 + len(dev["layout"]), n))
        sl.pack_batch_host(n, n, codes.astype(np.int32), ts_rel, None,
                           cols, null_masks, dev["layout"], out=host)
        t1 = time.perf_counter()
        packed = upload()
        t2 = time.perf_counter()
        self.stage_stats["pack_s"] += t1 - t0
        self.stage_stats["h2d_s"] += t2 - t1
        self.transfer_stats["h2d_bytes"] += int(host.nbytes)
        with kernel_family("session", self.dispatch_observer,
                           ready=self._device_values):
            inputs = sl.session_inputs(dev["spec"], dev["layout"], packed,
                                       dev["progs"])
            ssl = dev.get("ssl")
            if ssl is not None:
                # the batch goes to every key shard; the kernels drop the
                # records other shards own
                ssl.step(dev["arena"], dev["spare"], packed, inputs,
                         self.window.gap_ms, close_cut, delta)
                self.sharded_dispatches += 1
            else:
                sl.session_step(dev["spec"], dev["arena"], dev["spare"],
                                packed, inputs, self.window.gap_ms,
                                close_cut, delta)
        self._swap_arenas()

    def _dispatch_segment_merge(self, feed, order, starts, ends,
                                seg_of_row_sorted, seg_code, seg_t0,
                                seg_t1, close_cut, epoch, delta):
        """Segment-mode merge (times relative to `epoch`, the one after
        the rebase by `delta`): reduce the batch's rows into per-segment
        plane contributions with the host path's vectorized machinery
        (reduceat / add.at — exact, segments are gap-chains) and merge
        the segment arena into the session arena on the device."""
        dev = self._dev
        _tag, vv = feed
        t0 = time.perf_counter()
        seg = self._segment_planes(vv, order, starts, ends,
                                   seg_of_row_sorted, seg_code,
                                   seg_t0 - epoch,
                                   seg_t1 - epoch)
        t1 = time.perf_counter()
        self.transfer_stats["h2d_bytes"] += sum(
            int(v.nbytes) for v in seg.values())
        seg_t = {k: torch.from_numpy(v).to(self.device)
                 for k, v in seg.items()}
        self.stage_stats["pack_s"] += t1 - t0
        self.stage_stats["h2d_s"] += time.perf_counter() - t1
        with kernel_family("session", self.dispatch_observer,
                           ready=self._device_values):
            ssl = dev.get("ssl")
            if ssl is not None:
                # the segments go to every key shard; the kernels drop
                # the segments other shards own
                ssl.merge(dev["arena"], dev["spare"], seg_t,
                          self.window.gap_ms, close_cut, delta)
                self.sharded_dispatches += 1
            else:
                sl.session_merge(dev["spec"], dev["arena"], dev["spare"],
                                 seg_t, self.window.gap_ms, close_cut, delta)
        self._swap_arenas()

    def _segment_planes(self, vv, order, starts, ends, seg_of_row,
                        seg_code, seg_t0_rel, seg_t1_rel
                        ) -> dict[str, np.ndarray]:
        """Per-segment arena-format planes (numpy, one row per segment) —
        the same reductions as the host path's _segment_accs, emitted in
        device plane layout."""
        dev = self._dev
        spec = dev["spec"]
        nseg = len(starts)
        seg: dict[str, np.ndarray] = {
            "code": seg_code.astype(np.int32),
            "t0": np.asarray(seg_t0_rel, np.int32),
            "t1": np.asarray(seg_t1_rel, np.int32),
        }
        seg_len = None
        sorted_cache: dict = {}
        for i, (name, a) in enumerate(zip(
                sl.session_plane_names(spec), spec.aggs)):
            if name in seg:
                continue  # aliased plane (p50+p99 share the histogram)
            if a.kind == AggKind.COUNT_ALL:
                if seg_len is None:
                    seg_len = (ends - starts).astype(np.int64)
                seg[name] = seg_len.astype(np.int32)
                continue
            vals, ok = vv[i]
            hit = sorted_cache.get(id(vals))
            if hit is None:
                hit = (vals[order], ok[order])
                sorted_cache[id(vals)] = hit
            vs, okv = hit
            if a.kind == AggKind.COUNT:
                plane = np.add.reduceat(okv.astype(np.int64),
                                        starts).astype(np.int32)
            elif a.kind == AggKind.SUM:
                plane = np.add.reduceat(np.where(okv, vs, 0.0),
                                        starts).astype(np.float32)
            elif a.kind == AggKind.AVG:
                plane = np.add.reduceat(np.where(okv, vs, 0.0),
                                        starts).astype(np.float32)
                seg[name + "_n"] = np.add.reduceat(
                    okv.astype(np.int64), starts).astype(np.int32)
            elif a.kind == AggKind.MIN:
                plane = np.minimum.reduceat(
                    np.where(okv, vs, np.inf), starts).astype(np.float32)
            elif a.kind == AggKind.MAX:
                plane = np.maximum.reduceat(
                    np.where(okv, vs, -np.inf), starts).astype(np.float32)
            elif a.kind == AggKind.APPROX_COUNT_DISTINCT:
                plane = np.zeros((nseg, self.hll.m), np.int8)
                reg, rank = hll_update_np(
                    np.where(okv, vs, 0.0).astype(np.float32), self.hll)
                np.maximum.at(plane, (seg_of_row[okv], reg[okv]),
                              rank[okv])
            elif a.kind == AggKind.APPROX_QUANTILE:
                nb = self.qcfg.n_bins
                b = quantile_bin_np(
                    np.where(okv, vs, self.qcfg.min_value), self.qcfg)
                # bincount over the flattened (segment, bin) space is
                # ~5x np.add.at for the same scattered histogram
                flat = seg_of_row[okv] * nb + b[okv]
                plane = np.bincount(
                    flat, minlength=nseg * nb).astype(
                    np.int32).reshape(nseg, nb)
            else:
                raise SQLCodegenError(
                    f"session agg {a.kind} unsupported")
            seg[name] = plane
        return seg

    def _late_keep_mask(self, codes, ts) -> np.ndarray:
        """The order-dependent part of the reference semantics: walk the
        batch in (per-key) ts order over the INTERVAL mirror, dropping
        records that are past grace AND cannot merge into any session
        alive at their turn (SessionWindowedStream.hs:84-118). Interval
        state only — no accumulators — so this host walk costs a few
        list ops per record, and only on batches that actually carry
        possibly-late records."""
        gap = self.window.gap_ms
        grace = self.window.grace_ms
        wm = self.watermark
        n = len(codes)
        dev = self._dev
        batch_keys = set(codes.tolist())
        iv: dict[int, list[list[int]]] = {}
        for slot in np.nonzero(dev["mir_live"])[0].tolist():
            c = int(dev["mir_code"][slot])
            if c in batch_keys:
                iv.setdefault(c, []).append(
                    [int(dev["mir_t0"][slot]), int(dev["mir_t1"][slot])])
        keep = np.ones(n, np.bool_)
        order = np.lexsort((ts, codes))
        for p in order.tolist():
            c = int(codes[p])
            t = int(ts[p])
            lst = iv.setdefault(c, [])
            overl = [s for s in lst if s[0] - gap <= t <= s[1] + gap]
            if not overl:
                if t + gap + grace <= wm:
                    keep[p] = False
                    continue
                lst.append([t, t])
                continue
            m = overl[0]
            for s in overl[1:]:
                m[0] = min(m[0], s[0])
                m[1] = max(m[1], s[1])
                lst.remove(s)
            m[0] = min(m[0], t)
            m[1] = max(m[1], t)
        return keep

    def _rebase_delta(self, epoch: int, max_ts: int, anchor: int) -> int:
        """How far to re-anchor the device epoch when relative time nears
        int32 range (0: not yet). The caller moves the epoch only once
        the delta has ridden a step dispatch (the kernel shifts arena
        times in the same fused pass)."""
        if max_ts - epoch < self.REBASE_THRESHOLD:
            return 0
        return max(anchor - epoch, 0)

    def _grow_arena(self, need: int) -> None:
        """Double the arena capacity (pow2) — rare; both arenas of the
        ping-pong grow, the old slots keep their values."""
        dev = self._dev
        new_cap = round_up_pow2(need, lo=dev["cap"] * 2)
        ssl = dev.get("ssl")
        if ssl is not None:
            dev["arena"] = ssl.grow_arena(dev["arena"], new_cap)
            dev["spare"] = ssl.init_arena(new_cap)
        else:
            dev["arena"] = sl.grow_session_arena(dev["spec"], dev["arena"],
                                                 new_cap)
            dev["spare"] = sl.init_session_arena(dev["spec"], new_cap,
                                                 self.device)
        dev["cap"] = new_cap
        self.session_stats["grows"] += 1

    # contract: dispatches<=1 fetches<=0
    def _compact_codes_device(self) -> None:
        """Key-code compaction under the cache bound: keep only codes
        with live sessions, reassign dense codes in sorted order (the
        arena stays (code, t0)-sorted), remap the arena through the
        pow2-padded LUT kernel — one launch, no fetch. Dead codes map
        to the sentinel, so the remap doubles as eviction."""
        dev = self._dev
        live = dev["mir_live"]
        # pending deferred closes still decode by their PRE-remap codes
        # (the extracted device buffers keep them): resolve their key
        # columns against the old dictionary now
        self._resolve_pending_keys()
        live_codes = np.unique(dev["mir_code"][live]).astype(np.int64)
        lcap = round_up_pow2(max(len(self._code_rev), 1), lo=256)
        lut = np.full(lcap, sl.SESSION_SENT_CODE, np.int32)
        ssl = dev.get("ssl")
        if ssl is not None:
            # residue-class-preserving compaction (new mod n_shards ==
            # old mod n_shards): entries never change owner shard, and
            # within a shard the map keeps order, so every shard's arena
            # stays (code, t0)-sorted without a sort
            ns = ssl.n_shards
            new_of = np.empty(len(live_codes), np.int64)
            for s in range(ns):
                m = (live_codes % ns) == s
                new_of[m] = np.arange(int(m.sum()), dtype=np.int64) * ns + s
        else:
            new_of = np.arange(len(live_codes), dtype=np.int64)
        lut[live_codes] = new_of.astype(np.int32)
        lut_t = torch.from_numpy(lut).to(self.device)
        if ssl is not None:
            ssl.remap(dev["arena"], lut_t)
            self.sharded_dispatches += 1
        else:
            sl.session_remap(dev["arena"], lut_t)
        self.session_stats["remap_dispatches"] += 1
        new_code = np.full(len(dev["mir_code"]), -1, np.int64)
        pos = np.searchsorted(live_codes, dev["mir_code"][live])
        new_code[live] = new_of[pos]
        if ssl is not None:
            # dead mirror rows still occupy arena slots: keep their shard
            # residue (negative = poison; numpy's floor modulo keeps the
            # class) so the per-shard slot ranks stay aligned
            new_code[~live] = dev["mir_code"][~live] % ns - ns
        dev["mir_code"] = new_code
        # sharded new codes are class-strided, so the reverse index may
        # carry holes (None); only live codes ever decode through it
        top = int(new_of.max()) + 1 if len(live_codes) else 0
        new_rev: list = [None] * top
        for c, nc in zip(live_codes.tolist(), new_of.tolist()):
            new_rev[nc] = self._code_rev[c]
        self._code_rev = new_rev
        self._code_of = {k: i for i, k in enumerate(new_rev)
                         if k is not None}
        self._raw_memo = {}
        self._code_cols_cache = (-1, [])

    # contract: dispatches<=1 fetches<=1
    def _close_due_device(self):
        """Close every session past end + 2*gap + grace: the mirror
        names the due slots, ONE pow2-padded extract launch finalizes
        them on the card, ONE fetch brings the packed buffer down, and
        the decode is columnar (ColumnarEmit). With defer_close_decode
        the fetch is deferred: drain_closed() later stacks every pending
        cycle into one transfer per buffer shape. The arena retires the
        closed entries lazily on the next step (close_cut)."""
        dev = self._dev
        gap = self.window.gap_ms
        grace = self.window.grace_ms
        if self.watermark < 0:
            return []
        due = dev["mir_live"] & (dev["mir_t1"] + 2 * gap + grace
                                 <= self.watermark)
        idx = np.nonzero(due)[0]
        if len(idx) == 0:
            return []
        # launched first: a failed extract leaves every session open
        packed_dev = self._dispatch_extract(idx)
        self.session_stats["close_cycles"] += 1
        self.session_stats["close_dispatches"] += 1
        # the mirror rows are snapshotted NOW: the mirror mutates on the
        # next step, the deferred decode must not see that
        codes = dev["mir_code"][idx].copy()
        t0 = dev["mir_t0"][idx].copy()
        t1 = dev["mir_t1"][idx].copy()
        dev["mir_live"][idx] = False
        self._closed_wm = max(self._closed_wm, self.watermark)
        if self.defer_close_decode:
            # keep the packed batch on the device; no host sync
            self._pending_closes.append((codes, t0, t1, packed_dev,
                                         None))
            return []
        self.session_stats["close_fetches"] += 1
        packed_host = packed_dev.cpu().numpy()
        self.transfer_stats["d2h_bytes"] += packed_host.nbytes
        return self._decode_close(packed_host, codes, t0, t1)

    def _dispatch_extract(self, idx: np.ndarray) -> torch.Tensor:
        """One extract launch over the named arena slots (padded to a
        power of two) under the "close" kernel family; returns the
        packed buffer on the device (the caller fetches or defers). A
        fired device.session.dispatch fault raises before the launch
        (session.py:2100-2141 in the reference)."""
        dev = self._dev
        if FAULTS.active:  # chaos: fail/delay a session extract
            FAULTS.point("device.session.dispatch")
        ssl = dev.get("ssl")
        if ssl is not None:
            # per-shard slot lists [n_shards, pcap] (-1 pads), each
            # shard's in the order its rows appear in idx: the order
            # _flatten_sharded_extract reassembles by
            cls, slot = self._shard_slots()
            sel = cls[idx]
            per = np.bincount(sel, minlength=ssl.n_shards)
            pcap = round_up_pow2(max(int(per.max()), 1), lo=1)
            slots = np.full((ssl.n_shards, pcap), -1, np.int32)
            for s in range(ssl.n_shards):
                v = slot[idx[sel == s]]
                slots[s, :len(v)] = v
            self.sharded_dispatches += 1
            with kernel_family("close", self.dispatch_observer,
                               ready=self._device_values):
                return ssl.extract(dev["arena"], slots)
        with kernel_family("close", self.dispatch_observer,
                           ready=self._device_values):
            return sl.session_extract(dev["spec"], dev["arena"],
                                      pad_slots(idx))

    # contract: dispatches<=0 fetches<=1
    def drain_closed(self) -> list[dict[str, Any]]:
        """Decode every deferred session close. Multiple pending close
        cycles fetch in ONE device->host transfer per buffer shape
        (stack_pow2) — fetch count, not bytes, dominates drain cost. A
        fetch failure here propagates: the closed slots' mirror entries
        are already retired."""
        if not self._pending_closes:
            return []
        out = None
        by_shape: dict[tuple, list[tuple]] = {}
        for ent in self._pending_closes:
            by_shape.setdefault(tuple(ent[3].shape), []).append(ent)
        for group in by_shape.values():
            self.session_stats["close_fetches"] += 1
            if len(group) == 1:
                stacked = group[0][3].cpu().numpy()[None]
            else:
                stacked = stack_pow2(
                    [p for _c, _a, _b, p, _k in group]).cpu().numpy()
            self.transfer_stats["d2h_bytes"] += stacked.nbytes
            for (codes, t0, t1, _, keys), packed in zip(group, stacked):
                out = extend_rows(
                    out, self._decode_close(packed, codes, t0, t1, keys))
        self._pending_closes.clear()  # only after every decode succeeded
        return out if out is not None else []

    def has_pending_closes(self) -> bool:
        return bool(self._pending_closes)

    def flush_changes(self) -> list[dict[str, Any]]:
        """API parity with QueryExecutor's drain surface: sessions have
        no deferred changelog, so flushing delivers any deferred closes."""
        return self.drain_closed()

    # contract: dispatches<=0 fetches<=1
    def block_until_ready(self) -> None:
        if self._dev is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # contract: dispatches<=0 fetches<=0
    def device_plane_bytes(self) -> dict[str, int]:
        """Exact live device bytes per arena plane, both arenas of the
        ping-pong (host mode: empty — the numpy mirrors are not on the
        device)."""
        dev = self._dev
        if dev is None:
            return {}
        out: dict[str, int] = {}
        arenas = ((dev["arena"], dev["spare"]) if dev.get("ssl") is None
                  else (*dev["arena"], *dev["spare"]))
        for arena in arenas:
            for k, v in plane_bytes(arena).items():
                out[k] = out.get(k, 0) + v
        return out

    # contract: dispatches<=0 fetches<=0
    def _device_values(self):
        """Late-bound handle for the device-time sampler: the arena's
        tensors (their device names the stream the kernels launch on)."""
        dev = self._dev
        return dev["arena"] if dev is not None else ()

    @staticmethod
    def _flatten_sharded_extract(packed: np.ndarray,
                                 codes: np.ndarray) -> np.ndarray:
        """Sharded extract buffer [n_shards, 1 + n_aggs, pcap] -> the
        single-card [1 + n_aggs, k] layout: row r of the close's codes
        snapshot sits at (its shard, its rank among the snapshot's rows
        of that shard), the order _dispatch_extract built the per-shard
        slot lists in. Deferred buffers too: the codes snapshot predates
        any compaction, and the remap keeps residues."""
        ns = packed.shape[0]
        cls = (codes % ns).astype(np.int64)
        rank = np.empty(len(codes), np.int64)
        for s in range(ns):
            m = cls == s
            rank[m] = np.arange(int(m.sum()))
        return np.ascontiguousarray(packed[cls, :, rank].T)

    def _decode_close(self, packed: np.ndarray, codes, t0, t1,
                      keys=None):
        k = len(codes)
        if packed.ndim == 3:  # sharded extract: [n_shards, rows, pcap]
            packed = self._flatten_sharded_extract(packed, codes)
        if not np.array_equal(packed[0, :k], codes):
            raise AssertionError(
                "session mirror diverged from device arena codes")
        return self._decode_device_rows(packed, codes, t0, t1, keys)

    def _decode_device_rows(self, packed: np.ndarray, codes, t0, t1,
                            keys=None):
        """Fetched extract buffer -> ColumnarEmit: key decode is a
        cached reverse-index gather, agg values are already finalized on
        device (counts/HLL i32, floats f32-bitcast), window bounds come
        from the mirror snapshot taken at dispatch time."""
        n = len(codes)
        cols: dict[str, Any] = {}
        if keys is not None:  # resolved before a code-space compaction
            for name, arr in zip(self.group_cols, keys):
                cols[name] = arr
        else:
            for name, arr in zip(self.group_cols,
                                 self._code_rev_columns()):
                cols[name] = arr[codes.astype(np.int64)]
        row = 1
        for a in self.aggs:
            v = np.ascontiguousarray(packed[row, :n])
            if a.kind in (AggKind.COUNT_ALL, AggKind.COUNT,
                          AggKind.APPROX_COUNT_DISTINCT):
                cols[a.out_name] = v.astype(np.int64)
            else:
                cols[a.out_name] = v.view(np.float32).astype(np.float64)
            row += 1
        cols["winStart"] = t0.astype(np.int64)
        cols["winEnd"] = (t1 + self.window.gap_ms).astype(np.int64)
        return self._postprocess_session_cols(cols, n)

    def _code_rev_columns(self) -> list[np.ndarray]:
        """Per-group-column object arrays over the code dictionary for
        vectorized key decode; rebuilt only when codes changed."""
        version = len(self._code_rev)
        if self._code_cols_cache[0] != version:
            out = []
            for g in range(len(self.group_cols)):
                arr = np.empty(version, object)
                for i, key in enumerate(self._code_rev):
                    if key is not None:  # sharded-compaction hole
                        arr[i] = key[g]
                out.append(arr)
            self._code_cols_cache = (version, out)
        return self._code_cols_cache[1]

    # contract: dispatches<=1 fetches<=1
    def _peek_device(self):
        """Open-session rows without touching state: one read-only
        extract launch over every live slot + one fetch."""
        dev = self._dev
        idx = np.nonzero(dev["mir_live"])[0]
        if len(idx) == 0:
            return []
        packed_dev = self._dispatch_extract(idx)
        self.session_stats["peek_dispatches"] += 1
        return self._decode_close(packed_dev.cpu().numpy(),
                                  dev["mir_code"][idx].copy(),
                                  dev["mir_t0"][idx].copy(),
                                  dev["mir_t1"][idx].copy())
