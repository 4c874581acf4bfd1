"""Stream-stream interval JOIN execution (the port of
hstream_tpu/engine/join.py).

Reference semantics (hstream-processing Stream.hs:222-300 /
joinStreamProcessor): each record is inserted into its side's
timestamped KV store, then probed against the other side's store over
[ts - within, ts + within]; matching pairs (equal join key) emit a
joined record whose fields are the union of both sides qualified by
stream name (genJoiner, Internal/Codegen.hs:62-67) and whose timestamp
is max(ts1, ts2). The joined stream feeds the rest of the plan
(filter -> window aggregate -> ...), exactly like the reference's
merged-stream task DAG (Codegen.hs:253-266).

Two execution paths with identical semantics, as in the reference:

  * Device path (the hot one): both sides live as sorted stores on
    `device` (engine/join_lattice.py, hand-written Hopper kernels on the
    card). Each micro-batch is ONE wrapper call: when the downstream
    aggregate can fuse, the probe writes the matched pairs straight into
    the window step's inputs and the step scatters them into the inner
    lattice (join_probe_insert_step, nothing fetched); otherwise the
    probe packs a match buffer, fetched (deferred and stacked by
    `match_drain_depth`) and decoded columnar (join_probe_insert).
    Watermark eviction and the int32 epoch rebase are one two-sided
    compaction (join_evict). Activated once the columnar fast path is
    planned (`_plan_fast`); `use_device_join=False` forces the host path.
  * Host path (the equivalence reference): `_FlatIntervalStore` per
    side, flat sorted arrays probed with one searchsorted pair per
    batch. It serves the batches before the inner executor exists and
    plans the fast path cannot columnarize.

Join state is pruned by within + downstream grace, bounding memory
where the reference's in-memory store grows forever.

Differences from the reference, each deliberate:

  * No fallback that hides the device. The reference catches every
    failure of its device activation (kernel build, migration, OOM,
    an injected fault) and degrades to the host path
    (join.py:1121-1145, `device_fallbacks`); the port raises. Once the
    device path is active (`_dev is not None`), state never moves off
    it. `device_fallbacks` stays 0.
  * Each side keeps two stores on the card and the kernels write the
    other one (ping-pong); a store that a deferred match buffer may
    still re-probe is not reused (see `_store_out`).
  * A mesh whose key axis has more than one shard key-shards both side
    stores (parallel/lattice.py ShardedJoinLattice: shard s owns the
    codes with code mod n_shards == s) and the inner aggregate; a
    sharded join fuses only into a sharded inner lattice. A mesh with one
    key shard takes the single-card stores and a sharded inner aggregate
    (match-fetch path), as in the reference.
  * Left out, as the session port left them: the fault-injection point and the
    `kernel_family` dispatch observers (A5); `_host_store_view` and
    snapshots (A3).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from hstream_tpu_torch import device as devmod
from hstream_tpu_torch.common.columnar import extend_rows
from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.common.tracing import kernel_family
from hstream_tpu_torch.engine.expr import BinOp, Col, Expr, eval_host
from hstream_tpu_torch.engine.plan import AggregateNode
from hstream_tpu_torch.engine.statestore import LastValueStore
from hstream_tpu_torch.engine.types import canon_key, round_up_pow2
from hstream_tpu_torch.engine.window import DEFAULT_GRACE_MS
from hstream_tpu_torch.stats.devicecost import plane_bytes

_MISS = object()  # row.get sentinel: "field absent", distinct from None


def split_on_condition(on: Expr, left_streams: set[str],
                       right_streams: set[str]) -> tuple[list[Expr],
                                                         list[Expr]]:
    """Decompose `ON a.k1 = b.k2 [AND ...]` into per-side key-selector
    expression lists (evaluated over each side's RAW rows, so
    qualification is stripped). The reference's key selectors are
    functions of one side's record (Stream.hs:224-230)."""
    eqs: list[tuple[Expr, Expr]] = []

    def walk(e: Expr) -> None:
        if isinstance(e, BinOp) and e.op == "AND":
            walk(e.left)
            walk(e.right)
        elif isinstance(e, BinOp) and e.op == "=":
            eqs.append((e.left, e.right))
        else:
            raise SQLCodegenError(
                "JOIN ON must be a conjunction of equality comparisons")

    walk(on)

    def side_of(e: Expr) -> str:
        streams = set()

        def scan(x: Expr) -> None:
            if isinstance(x, Col):
                streams.add(x.stream)
            elif isinstance(x, BinOp):
                scan(x.left)
                scan(x.right)
            elif hasattr(x, "operand"):
                scan(x.operand)

        scan(e)
        named = {s for s in streams if s is not None}
        if named <= left_streams and named:
            return "l"
        if named <= right_streams and named:
            return "r"
        if not named:
            raise SQLCodegenError(
                "JOIN ON columns must be stream-qualified (s.col)")
        raise SQLCodegenError(
            f"JOIN ON side mixes streams {sorted(named)}")

    def strip(e: Expr) -> Expr:
        if isinstance(e, Col):
            return Col(e.name)
        if isinstance(e, BinOp):
            return BinOp(e.op, strip(e.left), strip(e.right))
        if hasattr(e, "operand"):
            return type(e)(e.op, strip(e.operand))
        return e

    lks: list[Expr] = []
    rks: list[Expr] = []
    for a, b in eqs:
        sa, sb = side_of(a), side_of(b)
        if sa == sb:
            raise SQLCodegenError("JOIN ON equality must relate both sides")
        if sa == "l":
            lks.append(strip(a))
            rks.append(strip(b))
        else:
            lks.append(strip(b))
            rks.append(strip(a))
    return lks, rks


class _JoinBase:
    """Shared plumbing of both join executors: alias/side routing, ON
    key split, joined-row construction, and the inner (downstream)
    executor lifecycle."""

    def __init__(self, plan, *, initial_keys: int = 1024,
                 batch_capacity: int = 4096,
                 device: str | torch.device | None = None, mesh=None):
        join = plan.join
        self.plan = plan
        # a mesh whose key axis has >1 shards key-shards both side stores
        # (code mod n_shards owns the entry) and the inner aggregate; with
        # one key shard the stores stay single-card and the inner
        # aggregate goes sharded through make_executor(mesh=), as in the
        # reference (join.py:221, :1172)
        self.mesh = mesh
        # launches of the key-sharded stores' programs (probe, fused step,
        # evict); the query task mirrors deltas into the
        # sharded_dispatches stat family
        self._sharded_dispatches = 0
        # the card unless the caller asks for the CPU (the inner executor
        # and the device stores live there)
        self.device = devmod.resolve(device)
        self.left_name = plan.source
        self.right_name = join.right.name
        if self.right_name == self.left_name:
            raise SQLCodegenError("self-join needs distinct streams")
        self.join_type = join.join_type
        if self.join_type not in ("INNER", "JOIN"):
            raise SQLCodegenError(
                f"{self.join_type} JOIN not supported (INNER only, like "
                "the reference's RJoinInner path)")
        self._aliases = {self.left_name: "l", self.right_name: "r"}
        left_al = {self.left_name}
        right_al = {self.right_name}
        la = getattr(plan, "source_alias", None)
        if la:
            self._aliases[la] = "l"
            left_al.add(la)
        if join.right.alias:
            self._aliases[join.right.alias] = "r"
            right_al.add(join.right.alias)
        self.left_keys, self.right_keys = split_on_condition(
            join.on, left_al, right_al)
        self._inner = None
        self._inner_plan = replace(plan, join=None)
        self._initial_keys = initial_keys
        self._batch_capacity = batch_capacity
        # deferred-change tuning proxied onto the (lazily created) inner
        # executor, so the server's _tune_executor and bench harnesses
        # treat a join exactly like a plain aggregate: the downstream
        # changelog extraction pipelines/batches instead of serializing
        # the join's compute loop with one D2H fetch per micro-batch
        self.emit_changes = bool(getattr(plan, "emit_changes", False))
        self.supports_deferred_changes = True
        self._inner_tuning: dict[str, object] = {}

    def _side_of(self, stream: str | None) -> str:
        if stream is None:
            raise SQLCodegenError(
                f"{type(self).__name__}.process requires stream=<name or "
                "alias>: a join consumes two streams and must know each "
                "batch's origin")
        side = self._aliases.get(stream)
        if side is None:
            raise SQLCodegenError(
                f"stream {stream!r} is not part of this join")
        return side

    def _joined_row(self, lrow: Mapping[str, Any],
                    rrow: Mapping[str, Any]) -> dict[str, Any]:
        """Union of both sides, stream-qualified (genJoiner); bare names
        kept as a convenience with left precedence."""
        out = {}
        for f, v in lrow.items():
            out[f"{self.left_name}.{f}"] = v
        for f, v in rrow.items():
            out[f"{self.right_name}.{f}"] = v
        for f, v in rrow.items():
            out.setdefault(f, v)
        for f, v in lrow.items():
            out[f] = v
        return out

    def _key(self, exprs: list[Expr], row: Mapping[str, Any]):
        try:
            vals = tuple(eval_host(e, row) for e in exprs)
        except (TypeError, KeyError):
            return None
        if any(v is None for v in vals):
            return None
        return canon_key(vals)

    @property
    def sharded_dispatches(self) -> int:
        """Sharded launches: the join's key-sharded stores' and the inner
        aggregate's own (step, extract)."""
        return self._sharded_dispatches + int(getattr(
            self._inner, "sharded_dispatches", 0) or 0)

    def _inner_process(self, joined, jts):
        if self._inner is None:
            from hstream_tpu_torch.sql.codegen import make_executor

            self._inner = make_executor(
                self._inner_plan, sample_rows=joined,
                initial_keys=self._initial_keys,
                batch_capacity=self._batch_capacity,
                device=self.device, mesh=self.mesh)
            self._apply_inner_tuning()
        return self._inner.process(joined, jts)

    def _apply_inner_tuning(self) -> None:
        inner = self._inner
        if inner is None or not getattr(inner, "supports_deferred_changes",
                                        False):
            return
        for k, v in self._inner_tuning.items():
            setattr(inner, k, v)

    def _proxy_tuning(self, name: str, value) -> None:
        self._inner_tuning[name] = value
        self._apply_inner_tuning()

    # change-drain knobs ride through to the inner executor (set before
    # OR after its lazy creation); reads fall back to the pending value
    @property
    def defer_change_decode(self) -> bool:
        return bool(self._inner_tuning.get("defer_change_decode", False))

    @defer_change_decode.setter
    def defer_change_decode(self, v: bool) -> None:
        self._proxy_tuning("defer_change_decode", bool(v))

    @property
    def change_drain_depth(self) -> int:
        return int(self._inner_tuning.get("change_drain_depth", 1))

    @change_drain_depth.setter
    def change_drain_depth(self, v: int) -> None:
        self._proxy_tuning("change_drain_depth", int(v))

    @property
    def async_change_drain(self) -> bool:
        return bool(self._inner_tuning.get("async_change_drain", False))

    @async_change_drain.setter
    def async_change_drain(self, v: bool) -> None:
        self._proxy_tuning("async_change_drain", bool(v))

    # ---- drains (API parity with QueryExecutor) ----------------------------

    def flush_changes(self) -> list[dict[str, Any]]:
        """Deliver every lagging emission: coalesced match rows staged
        for the inner step first, then the inner executor's deferred
        changelog extracts — the same barrier QueryExecutor exposes.
        A lone columnar change batch rides through unmaterialized."""
        rows = (self.flush_staged()
                if hasattr(self, "flush_staged") else [])
        inner = self._inner
        if inner is not None and hasattr(inner, "flush_changes"):
            rows = extend_rows(rows, inner.flush_changes())
        return rows if rows is not None else []

    def has_pending_changes(self) -> bool:
        if getattr(self, "_staged_n", 0):
            return True
        if getattr(self, "_pending_matches", None):
            return True
        inner = self._inner
        if inner is None:
            return False
        hp = getattr(inner, "has_pending_changes", None)
        if hp is not None:
            return bool(hp())
        return bool(getattr(inner, "_pending_changes", None))

    def peek(self) -> list[dict[str, Any]]:
        return [] if self._inner is None else self._inner.peek()

    def read_version(self) -> tuple | None:
        """Read-cache validity key: peek() serves the inner
        aggregate's state, so the version IS the inner's — prefixed
        pre-creation so an empty join caches too. None (inner without
        versioning) disables caching for this executor."""
        inner = self._inner
        if inner is None:
            return ("join-empty", id(self))
        fn = getattr(inner, "read_version", None)
        return None if fn is None else fn()

    def live_min_win_end(self) -> int | None:
        """Smallest live winEnd of the inner aggregate (the read
        plane's closed-only fast path); None = no live window could emit one."""
        fn = getattr(self._inner, "live_min_win_end", None)
        return None if fn is None else fn()

    def close_due_windows(self) -> list[dict[str, Any]]:
        if self._inner is None or not hasattr(self._inner,
                                              "close_due_windows"):
            return []
        return self._inner.close_due_windows()

    def block_until_ready(self) -> None:
        if self._inner is not None and hasattr(self._inner,
                                               "block_until_ready"):
            self._inner.block_until_ready()

    def device_plane_bytes(self) -> dict[str, int]:
        """Device bytes of the inner aggregate's planes, "agg."-
        prefixed (JoinExecutor extends this with its device stores),
        nbytes metadata reads only."""
        fn = getattr(self._inner, "device_plane_bytes", None)
        if fn is None:
            return {}
        return {f"agg.{k}": v for k, v in fn().items()}


class TableJoinExecutor(_JoinBase):
    """Executes `SELECT ... FROM l INNER JOIN TABLE(r) ON ...`.

    Reference semantics (Stream.hs:302-344, joinStreamTable): the right
    side is a TABLE — the latest row per join key of a changelog stream.
    Stream records probe the table and emit one joined row when the key
    is present; table records only update state (no retroactive
    emission). State is bounded by the table's key cardinality.
    """

    def __init__(self, plan, *, initial_keys: int = 1024,
                 batch_capacity: int = 4096,
                 device: str | torch.device | None = None):
        super().__init__(plan, initial_keys=initial_keys,
                         batch_capacity=batch_capacity, device=device)
        # the keyed last-value table (engine.statestore.LastValueStore)
        self._table = LastValueStore()

    @property
    def table(self) -> dict:
        """key -> (ts, row) view of the last-value table (snapshots,
        introspection)."""
        return self._table.data

    def process(self, rows: Sequence[Mapping[str, Any]],
                ts_ms: Sequence[int], stream: str | None = None
                ) -> list[dict[str, Any]]:
        side = self._side_of(stream)
        if side == "r":
            for row, ts in zip(rows, ts_ms):
                key = self._key(self.right_keys, row)
                if key is None:
                    continue
                self._table.update(key, int(ts), row)
            return []
        joined: list[dict[str, Any]] = []
        jts: list[int] = []
        for row, ts in zip(rows, ts_ms):
            key = self._key(self.left_keys, row)
            if key is None:
                continue
            match = self._table.lookup(key)
            if match is None:
                continue  # INNER: stream rows without a table row drop
            joined.append(self._joined_row(row, match))
            jts.append(int(ts))
        if not joined:
            return []
        return self._inner_process(joined, jts)


class _FlatIntervalStore:
    """One side of the interval join as flat sorted arrays.

    Rows live in arrays sorted by a composite (key code, ts) int64 —
    code * 2^41 + (ts - t0) — so a WHOLE batch probes with one
    searchsorted pair and inserts with one np.insert: no per-key Python.
    The reference walks a per-record ordered map instead
    (Processing/Store.hs tksPut/tksRange); this is that store's batch
    restatement. Key codes are dense ints owned by the executor
    (shared across both sides so probes and inserts agree).
    """

    TS_BITS = 41                     # ~69 years of ms offsets
    SPAN = 1 << TS_BITS

    def __init__(self, key_rev: list):
        self.code = np.empty(0, np.int64)
        self.ts = np.empty(0, np.int64)
        self.comp = np.empty(0, np.int64)
        self.rows = np.empty(0, object)
        self.t0: int | None = None
        self.key_rev = key_rev       # shared code -> canon key (executor)

    def __len__(self) -> int:
        return len(self.code)

    def _rebase(self, t0: int) -> None:
        self.t0 = t0
        self.comp = self.code * self.SPAN + (self.ts - t0)

    def insert_sorted(self, code: np.ndarray, ts: np.ndarray,
                      rows: np.ndarray) -> None:
        """Insert a batch already sorted by (code, ts)."""
        if len(code) == 0:
            return
        mn = int(ts.min())
        new_t0 = mn if self.t0 is None else min(mn, self.t0)
        hi = int(ts.max())
        if len(self.ts):
            hi = max(hi, int(self.ts.max()))
        if hi - new_t0 >= self.SPAN:
            # an offset past 2^41 ms (~69 years) would overflow into a
            # neighboring code's composite range and silently corrupt
            # probes — loud failure beats wrong join results. Checked
            # over existing AND incoming rows: a rebase to an older t0
            # shifts every resident row's offset too.
            raise SQLCodegenError(
                "join record timestamps span more than 2^41 ms; "
                "timestamps must be epoch milliseconds")
        if self.t0 is None or new_t0 < self.t0:
            self._rebase(new_t0)
        bcomp = code * self.SPAN + (ts - self.t0)
        if len(self.comp) == 0:
            self.code, self.ts, self.comp = code, ts, bcomp
            self.rows = rows
            return
        idx = np.searchsorted(self.comp, bcomp)
        self.code = np.insert(self.code, idx, code)
        self.ts = np.insert(self.ts, idx, ts)
        self.comp = np.insert(self.comp, idx, bcomp)
        self.rows = np.insert(self.rows, idx, rows)

    def probe(self, code: np.ndarray, lo_ts: np.ndarray,
              hi_ts: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
        """Per query i: [start, end) indices of rows with this code and
        lo_ts[i] <= ts <= hi_ts[i]."""
        if len(self.comp) == 0:
            return None
        lo = np.clip(lo_ts - self.t0, 0, self.SPAN - 1)
        hi = np.clip(hi_ts - self.t0, -1, self.SPAN - 1)
        lo_i = np.searchsorted(self.comp, code * self.SPAN + lo, "left")
        hi_i = np.searchsorted(self.comp, code * self.SPAN + hi, "right")
        return lo_i, np.maximum(hi_i, lo_i)

    def prune(self, min_ts: int) -> None:
        keep = self.ts >= min_ts
        if not keep.all():
            self.code = self.code[keep]
            self.ts = self.ts[keep]
            self.comp = self.comp[keep]
            self.rows = self.rows[keep]

    def remap_codes(self, new_of_old: np.ndarray,
                    resort: bool = False) -> None:
        """Apply a code compaction. A dense remap preserves sorted order;
        a shard-class-preserving remap (key-sharded device stores) does
        not, so ``resort`` re-sorts by the new composite."""
        self.code = new_of_old[self.code]
        if self.t0 is None:
            return
        self.comp = self.code * self.SPAN + (self.ts - self.t0)
        if resort and len(self.comp):
            order = np.argsort(self.comp, kind="stable")
            self.code = self.code[order]
            self.ts = self.ts[order]
            self.comp = self.comp[order]
            self.rows = self.rows[order]

    @property
    def by_key(self) -> dict:
        """key tuple -> (ts list, rows list) view (snapshots; same shape
        TimestampedKVStore exposes, so the blob format is unchanged)."""
        out: dict[tuple, tuple[list, list]] = {}
        for i in range(len(self.code)):
            key = self.key_rev[int(self.code[i])]
            tss, rows = out.setdefault(key, ([], []))
            tss.append(int(self.ts[i]))
            rows.append(self.rows[i])
        return out


class JoinExecutor(_JoinBase):
    """Executes `SELECT ... FROM l [INNER|LEFT] JOIN r WITHIN(...) ON ...`.

    API: process(rows, ts_ms, stream=<source name or alias>) — the task
    runtime feeds records from BOTH streams through the one executor,
    tagging each batch with its origin (the reference merges both
    sources into one task, Codegen.hs:250-266). Joined rows feed the
    inner (aggregate/stateless) executor built over the joined schema.
    """

    # the task runtime may feed columnar batches straight through
    # process_columnar (no row materialization on the server path)
    supports_columnar_join = True

    def __init__(self, plan, *, initial_keys: int = 1024,
                 batch_capacity: int = 4096,
                 device: str | torch.device | None = None, mesh=None):
        super().__init__(plan, initial_keys=initial_keys,
                         batch_capacity=batch_capacity, device=device,
                         mesh=mesh)
        join = plan.join
        self.within = join.within.ms

        # retention: a future in-grace record can probe back `within`;
        # grace defaults to the downstream window's (or the SQL default)
        node = plan.node
        grace = DEFAULT_GRACE_MS
        if isinstance(node, AggregateNode) and node.window is not None:
            grace = node.window.grace_ms
        self.retention_ms = self.within + grace

        # shared join-key code space across both sides
        self._jcode: dict[tuple, int] = {}
        self._jcode_rev: list[tuple] = []
        self._kid_lut = np.full(1024, -1, np.int32)  # code -> inner key id
        self._stores = {"l": _FlatIntervalStore(self._jcode_rev),
                        "r": _FlatIntervalStore(self._jcode_rev)}
        self.watermark: int = -1
        # fast-path plumbing (computed lazily once the inner executor
        # and both sides' observed fields exist)
        self._fields = {"l": set(), "r": set()}
        self._fast: dict | None = None   # None = unknown yet
        # opt-in: accumulate this many matched rows before stepping the
        # inner executor — on a real link every step dispatch pays a
        # round trip, so small probe batches must coalesce (the same
        # lever as the ingest pipeline's staged caps). Emission then
        # lags by the coalesce horizon; callers flush via flush_staged.
        self.coalesce_rows = 0
        self._staged: list[tuple] = []   # (key_ids, jts, cols, nulls)
        self._staged_n = 0
        # Device-resident join: once the columnar fast path is planned,
        # both sides migrate into stores on self.device and each
        # micro-batch is ONE wrapper call (engine/join_lattice.py): the
        # fused probe + window step, or the probe + insert whose packed
        # match buffer is fetched. use_device_join=False pins the host
        # reference path.
        self.use_device_join = True
        self._dev: dict | None = None
        # >1 defers match-buffer fetches: buffers stack into one
        # batched D2H transfer every `depth` micro-batches, so the
        # round trip amortizes (emission then lags; flush_staged is
        # the barrier). The fused close's deferred-fetch idiom.
        self.match_drain_depth = 1
        self._pending_matches: list[tuple] = []
        # probe-path accounting: the device-join contract is ONE probe
        # wrapper call per micro-batch (and fetches <= batches); tests
        # and chip_smoke assert probe_dispatches == probe_batches
        self.join_stats = {
            "probe_batches": 0, "probe_dispatches": 0,
            "probe_fetches": 0, "match_redispatches": 0,
            "evict_dispatches": 0, "rebase_dispatches": 0,
            "store_grows": 0, "fused_batches": 0,
        }
        # the reference's count of activations degraded to the host path;
        # the port raises instead, so it stays 0
        self.device_fallbacks = 0
        self.dispatch_observer = None   # callable (family, seconds)
        # host seconds of the device path's per-batch stages (host clock)
        self.stage_stats = {"key_encode_s": 0.0, "lexsort_s": 0.0,
                            "shadow_s": 0.0, "pack_s": 0.0, "h2d_s": 0.0}

    def device_plane_bytes(self) -> dict[str, int]:
        """Exact per-plane device bytes: both sides' interval stores
        ("l."/"r."-prefixed) plus the inner aggregate's lattice planes
        ("agg."-prefixed), nbytes metadata reads."""
        out = super().device_plane_bytes()
        dev = self._dev
        if dev is not None:
            for side in ("l", "r"):
                st = dev["stores"][side]
                for shard in (st if isinstance(st, list) else [st]):
                    for k, v in plane_bytes(shard).items():
                        out[f"{side}.{k}"] = out.get(f"{side}.{k}", 0) + v
        return out

    # contract: dispatches<=0 fetches<=0
    def _device_values(self):
        """Live device tensors of the probe plane — the device-time
        sampler's target, late-bound (the stores swap with their spares
        on every probe): both stores and the inner lattice's planes."""
        dev = self._dev
        if dev is None:
            return ()
        vals = [dev["stores"]["l"], dev["stores"]["r"]]
        inner_state = getattr(self._inner, "state", None)
        if inner_state is not None:
            vals.append(inner_state)
        return vals

    # ---- ingest ------------------------------------------------------------
    #
    # Batched: the per-record reference loop (insert my side, probe the
    # other side over [ts-within, ts+within], Stream.hs:238-300) is
    # restated as: group the batch by join key, batch-append each group
    # to my side's store, then probe the other side with ONE
    # searchsorted pair per group (the other side never changes during
    # the batch, so insert/probe need no interleaving). Matched pairs
    # feed the inner aggregate COLUMNAR (key ids broadcast per group
    # when the GROUP BY key is the join key) — no joined-row dicts on
    # the steady path.

    def process(self, rows: Sequence[Mapping[str, Any]],
                ts_ms: Sequence[int], stream: str | None = None
                ) -> list[dict[str, Any]]:
        side = self._side_of(stream)
        mine = self._stores[side]
        other = self._stores["r" if side == "l" else "l"]
        my_keys = self.left_keys if side == "l" else self.right_keys
        n = len(rows)
        out: list[dict[str, Any]] = []
        if n:
            if rows[0]:
                self._fields[side].update(rows[0])
            ts = np.asarray(ts_ms, np.int64)
            codes = self._batch_codes(my_keys, rows)       # -1 = no key
            keep = codes >= 0
            if not keep.all():
                kidx = np.nonzero(keep)[0]
                codes = codes[kidx]
                bts = ts[kidx]
            else:
                kidx = None
                bts = ts
            if len(codes):
                order = np.lexsort((bts, codes))
                codes = codes[order]
                bts = bts[order]
                ridx = order if kidx is None else kidx[order]
                if self._device_ready():
                    lay = self._dev["lay"][side]
                    flags, vals = self._encode_join_cols(
                        lay, [rows[j] for j in ridx.tolist()])
                    out = self._device_batch(side, codes, bts, flags,
                                             vals)
                else:
                    out = self._host_batch(side, mine, other, codes,
                                           bts, rows, ridx)
        self._advance_watermark(max((int(t) for t in ts_ms),
                                    default=self.watermark))
        return out

    def process_columnar(self, ts_ms, cols: Mapping[str, np.ndarray],
                         nulls: Mapping[str, np.ndarray] | None = None,
                         *, stream: str | None = None
                         ) -> list[dict[str, Any]]:
        """Columnar twin of process(): int64 absolute-ms timestamps plus
        named numpy columns (str/object arrays for strings; a null-mask
        cell means the field is ABSENT from that record, like the
        per-record decode's dropped keys). On the device path the batch
        packs straight from the columns — vectorized key encode, no
        per-row Python at all; until the device path activates (or on
        the host reference path) rows materialize once and take the row
        path, so semantics are identical."""
        n = len(ts_ms)
        if n == 0:
            return []
        side = self._side_of(stream)
        self._fields[side].update(cols.keys())
        ts = np.asarray(ts_ms, np.int64)
        out: list[dict[str, Any]] = []
        enc = None
        if self._device_ready():
            my_keys = (self.left_keys if side == "l"
                       else self.right_keys)
            enc = self._columnar_batch(side, my_keys, ts, cols, nulls)
        if enc is not None:
            codes, bts, flags, vals = enc
            if len(codes):
                out = self._device_batch(side, codes, bts, flags, vals)
            self._advance_watermark(int(ts.max()))
            return out
        # fallback: materialize rows once (pre-activation, non-Col ON
        # keys, or untyped columns) and run the row path
        return self.process(self._rows_from_cols(cols, nulls, n),
                            ts.tolist(), stream=stream)

    def _advance_watermark(self, new_wm: int) -> None:
        if new_wm <= self.watermark:
            return
        self.watermark = new_wm
        cutoff = self.watermark - self.retention_ms
        if cutoff > 0:
            if self._dev is not None:
                self._maybe_evict(cutoff)
            else:
                self._stores["l"].prune(cutoff)
                self._stores["r"].prune(cutoff)

    def _host_batch(self, side, mine, other, codes, bts, rows,
                    ridx) -> list[dict[str, Any]]:
        """The host reference path: batch searchsorted probe over the
        flat sorted stores (see _FlatIntervalStore)."""
        brows = np.empty(len(ridx), object)
        for i, j in enumerate(ridx.tolist()):
            brows[i] = dict(rows[j])
        # probe the other side BEFORE inserting: the reference
        # loop probes only the opposite store, which this batch
        # never mutates, so insert/probe need no interleaving
        pr = other.probe(codes, bts - self.within, bts + self.within)
        mine.insert_sorted(codes, bts, brows)
        if pr is None:
            return []
        lo_i, hi_i = pr
        cnt = hi_i - lo_i
        tot = int(cnt.sum())
        if not tot:
            return []
        start = np.cumsum(cnt) - cnt
        oidx = (np.arange(tot, dtype=np.int64)
                - np.repeat(start, cnt)
                + np.repeat(lo_i, cnt))
        rep = np.repeat(np.arange(len(codes)), cnt)
        jts = np.maximum(bts[rep], other.ts[oidx])
        return self._emit_matches(side, brows, rep, codes[rep], other,
                                  oidx, jts)

    def _batch_codes(self, my_keys, rows) -> np.ndarray:
        """Dense join-key code per row (-1 = null key, skipped). One
        shared code space for both sides; compacted when it outgrows
        the composite-key budget."""
        # compact BEFORE encoding so this batch's fresh keys get live
        # codes (compacting afterwards would remap them to -1 and drop
        # the rows)
        if len(self._jcode_rev) + len(rows) >= (1 << 22) - 1:
            self._compact_codes()
            if len(self._jcode_rev) + len(rows) >= (1 << 22) - 1:
                raise SQLCodegenError(
                    "join key cardinality within the retention window "
                    f"exceeds {1 << 22} distinct keys")
        jcode = self._jcode
        rev = self._jcode_rev
        out = np.empty(len(rows), np.int64)

        def code_of(k) -> int:
            c = jcode.get(k)
            if c is None:
                c = len(rev)
                jcode[k] = c
                rev.append(k)
            return c

        if all(isinstance(e, Col) for e in my_keys):
            names = [e.name for e in my_keys]
            if len(names) == 1:
                nm = names[0]
                for i, r in enumerate(rows):
                    v = r.get(nm)
                    out[i] = -1 if v is None else code_of(canon_key((v,)))
            else:
                for i, r in enumerate(rows):
                    vals = tuple(r.get(c) for c in names)
                    out[i] = (-1 if any(v is None for v in vals)
                              else code_of(canon_key(vals)))
        else:
            for i, r in enumerate(rows):
                k = self._key(my_keys, r)
                out[i] = -1 if k is None else code_of(k)
        return out

    def _compact_codes(self) -> None:
        """Code-space compaction: keep only codes still live in either
        store (retention bounds them), reassign codes, remap stores +
        shadows + lut + dict. The device path fetches both sides' code
        planes in one stacked transfer (they share cap) and remaps them
        on the device.

        Single-card remaps densely in sorted order (store order is
        preserved). Key-sharded stores must keep every code's shard, so
        the remap there keeps residues (new = rank within class *
        n_shards + class): each shard's order survives the remap, but
        the global (code, ts) order does not, so the host shadows
        re-sort, and the code space keeps holes where the classes are
        unbalanced."""
        from hstream_tpu_torch.engine import join_lattice as jl

        sjl = self._dev.get("sjl") if self._dev is not None else None
        parts = [self._stores["l"].code, self._stores["r"].code]
        if self._dev is not None:
            self._refresh_counts()
            if self._dev["n"]["l"] or self._dev["n"]["r"]:
                st = self._dev["stores"]
                planes = ([st["l"]["code"], st["r"]["code"]] if sjl is None
                          else [x["code"] for x in st["l"] + st["r"]])
                # key shards on other cards are copied to shard 0's first
                codes = torch.stack([p.to(planes[0].device)
                                     for p in planes]).cpu().numpy()
                # eviction is lazy: dead-but-resident entries past the
                # live prefix must stay mapped too, so take every
                # non-sentinel slot
                parts.append(np.unique(
                    codes[codes < jl.JOIN_SENT_CODE]).astype(np.int64))
        live = np.union1d(parts[0], np.concatenate(parts[1:]))
        if sjl is not None:
            cls = live % sjl.n_shards
            new_codes = np.empty(len(live), np.int64)
            for s in range(sjl.n_shards):
                msk = cls == s
                new_codes[msk] = (np.arange(int(msk.sum()), dtype=np.int64)
                                  * sjl.n_shards + s)
        else:
            new_codes = np.arange(len(live), dtype=np.int64)
        new_of_old = np.full(len(self._jcode_rev), -1, np.int64)
        new_of_old[live] = new_codes
        resort = sjl is not None
        for st in self._stores.values():
            st.remap_codes(new_of_old, resort=resort)
        if self._dev is not None:
            for st in self._dev["shadow"].values():
                # the shadows size every match buffer: leaving them on
                # the old code space would corrupt probe totals
                st.remap_codes(new_of_old, resort=resort)
            self._remap_device_codes(new_of_old)
        new_rev: list = [None] * (int(new_codes.max()) + 1 if len(live)
                                  else 0)
        for nc, oc in zip(new_codes.tolist(), live.tolist()):
            new_rev[nc] = self._jcode_rev[oc]
        self._jcode.clear()
        self._jcode.update({k: i for i, k in enumerate(new_rev)
                            if k is not None})
        self._jcode_rev[:] = new_rev      # in place: stores share it
        lut = np.full(max(len(new_rev), 1024), -1, np.int32)
        old_lut = self._kid_lut
        inb = live < len(old_lut)
        lut[new_codes[inb]] = old_lut[live[inb]]
        self._kid_lut = lut

    # ---- match emission ----------------------------------------------------

    def _feed_inner_columnar(self, key_ids, jts, cols, nulls
                             ) -> list[dict[str, Any]]:
        """Step (or coalesce-stage) one columnar match batch into the
        inner executor — shared by the host and device probe paths.
        The joined stream's watermark is the JOIN's watermark (both
        probe paths forward it before stepping matches, so the fused
        device kernel and this host feed apply the same late mask)."""
        inner = self._inner
        if (getattr(inner, "watermark_abs", None) is not None
                and self.watermark > inner.watermark_abs):
            inner.watermark_abs = self.watermark
        if self.coalesce_rows > 0:
            self._staged.append((key_ids, jts, cols, nulls))
            self._staged_n += len(key_ids)
            if self._staged_n < self.coalesce_rows:
                return []
            return self._drain_staged(keep_tail=True)
        return self._inner.process_columnar(key_ids, jts, cols, nulls)

    def _emit_matches(self, side, brows, rep, mcodes, other, oidx,
                      jts) -> list[dict[str, Any]]:
        fast = self._fast_info()
        if fast is not None:
            key_ids = self._match_key_ids(mcodes)
            cols, nulls = self._match_cols(fast, side, brows, rep,
                                           other, oidx)
            return self._feed_inner_columnar(key_ids, jts, cols, nulls)
        # general path: materialize joined-row dicts (also the sample
        # source for the inner executor's construction)
        orows = other.rows[oidx]
        joined: list[dict[str, Any]] = []
        for i in range(len(rep)):
            row, orow = brows[rep[i]], orows[i]
            joined.append(self._joined_row(row, orow) if side == "l"
                          else self._joined_row(orow, row))
        res = self._inner_process(joined, jts.tolist())
        # re-plan while disabled: a field observed on a later batch can
        # make a previously-unresolvable column resolvable
        if not self._fast:
            self._plan_fast()
        return res

    def _match_key_ids(self, mcodes: np.ndarray) -> np.ndarray:
        """Inner-executor key ids per match via a code-indexed LUT (the
        GROUP BY key IS the join key on this path)."""
        lut = self._kid_lut
        if len(lut) < len(self._jcode_rev):
            grown = np.full(max(len(self._jcode_rev), 2 * len(lut)),
                            -1, np.int32)
            grown[:len(lut)] = lut
            self._kid_lut = lut = grown
        need = np.unique(mcodes[lut[mcodes] < 0])
        for c in need.tolist():
            lut[c] = self._inner.key_id_for(self._jcode_rev[c])
        return lut[mcodes]

    def flush_staged(self) -> list[dict[str, Any]]:
        """Step the inner executor with every lagging match: deferred
        device match buffers fetch + decode first (they may stage into
        the coalesce buffer), then every coalesced row steps. A lone
        columnar batch from either half stays a ColumnarEmit."""
        out = self._drain_matches() if self._pending_matches else None
        out = extend_rows(out, self._drain_staged(keep_tail=False))
        return out if out is not None else []

    def _drain_staged(self, *, keep_tail: bool) -> list[dict[str, Any]]:
        """Step coalesced matches. keep_tail=True steps only whole
        inner-batch-capacity chunks and re-stages the remainder, so the
        steady state steps in the inner executor's own batch size."""
        if not self._staged:
            return []
        staged, self._staged = self._staged, []
        self._staged_n = 0
        key_ids = np.concatenate([s[0] for s in staged])
        jts = np.concatenate([s[1] for s in staged])
        names = staged[0][2].keys()
        cols = {c: np.concatenate([s[2][c] for s in staged])
                for c in names}
        nulls = None
        if any(s[3] for s in staged):
            nulls = {}
            for c in names:
                parts = [s[3][c] if (s[3] and c in s[3])
                         else np.zeros(len(s[0]), np.bool_)
                         for s in staged]
                m = np.concatenate(parts)
                if m.any():
                    nulls[c] = m
            nulls = nulls or None
        n = len(key_ids)
        cap = self._inner.batch_capacity
        cut = n - (n % cap) if keep_tail else n
        if keep_tail and cut < n:
            tail_nulls = (None if nulls is None else
                          {c: m[cut:] for c, m in nulls.items()})
            self._staged.append((key_ids[cut:], jts[cut:],
                                 {c: v[cut:] for c, v in cols.items()},
                                 tail_nulls))
            self._staged_n = n - cut
        if cut == 0:
            return []
        head_nulls = (None if nulls is None else
                      {c: m[:cut] for c, m in nulls.items()})
        return self._inner.process_columnar(
            key_ids[:cut], jts[:cut],
            {c: v[:cut] for c, v in cols.items()}, head_nulls)

    def _fast_info(self) -> dict | None:
        if self._fast is None and self._inner is not None:
            self._plan_fast()
        return self._fast if isinstance(self._fast, dict) else None

    def _resolve_col(self, name: str) -> tuple[str, str] | None:
        """Joined-row column name -> (side, source column): qualified
        names split on the alias; bare names take left precedence, the
        same rule _joined_row applies."""
        if "." in name:
            pre, col = name.split(".", 1)
            s = self._aliases.get(pre)
            if s is not None:
                return s, col
        if name in self._fields["l"]:
            return "l", name
        if name in self._fields["r"]:
            return "r", name
        return None

    def close_due_windows(self) -> list[dict[str, Any]]:
        rows = (self.flush_staged()
                if (self._staged or self._pending_matches) else [])
        # flush_staged can surface a lone ColumnarEmit (no .extend)
        rows = extend_rows(rows, super().close_due_windows())
        return rows if rows is not None else []

    def _plan_fast(self) -> None:
        """Enable the columnar match path when (a) the inner executor
        has one, (b) its GROUP BY columns are exactly the join key (so
        inner key ids broadcast per probe group), and (c) every column
        the inner step needs resolves to one side."""
        inner = self._inner
        self._fast = False
        if inner is None or not hasattr(inner, "process_columnar"):
            return
        # after a snapshot restore the observed-field sets are empty;
        # reseed them from any stored row so bare names still resolve
        for s in ("l", "r"):
            if not self._fields[s] and len(self._stores[s]):
                self._fields[s].update(self._stores[s].rows[0])
        knames_l = ([e.name for e in self.left_keys]
                    if all(isinstance(e, Col) for e in self.left_keys)
                    else None)
        knames_r = ([e.name for e in self.right_keys]
                    if all(isinstance(e, Col) for e in self.right_keys)
                    else None)
        resolved = [self._resolve_col(c) for c in inner.group_cols]
        if any(r is None for r in resolved):
            return
        gs = [s for s, _ in resolved]
        gcols = [c for _, c in resolved]
        if not (len(set(gs)) == 1
                and ((gs[0] == "l" and gcols == knames_l)
                     or (gs[0] == "r" and gcols == knames_r))):
            return
        need = {}
        for name in inner._needed_cols:
            if "." in name:
                pre, col = name.split(".", 1)
                s = self._aliases.get(pre)
                if s is not None:
                    need[name] = (s, col)
                    continue
            if (name in self._fields["l"]
                    or name in self._fields["r"]):
                # bare name: gather per match row with _joined_row's
                # left-precedence (observation can't tell which side a
                # heterogeneous stream carries the field on)
                need[name] = ("both", name)
            else:
                return
        self._fast = {"need": need}

    def _match_cols(self, fast, side, brows, rep, other,
                    oidx) -> tuple[dict, dict | None]:
        """Columns the inner step needs, gathered straight from the
        matched source rows (no joined dicts)."""
        from hstream_tpu_torch.engine.types import ColumnType

        inner = self._inner
        tot = len(rep)
        cols: dict[str, np.ndarray] = {}
        nulls: dict[str, np.ndarray] = {}
        src_cache: dict[tuple, list] = {}
        for name, (cside, col) in fast["need"].items():
            vals = src_cache.get((cside, col))
            if vals is None:
                if cside == "both":
                    # left-precedence bare name, decided per match row
                    lrows, lidx = ((brows, rep) if side == "l"
                                   else (other.rows, oidx))
                    rrows, ridx = ((other.rows, oidx) if side == "l"
                                   else (brows, rep))
                    vals = []
                    for li, ri in zip(lidx.tolist(), ridx.tolist()):
                        v = lrows[li].get(col, _MISS)
                        if v is _MISS:
                            v = rrows[ri].get(col)
                        vals.append(v)
                elif cside == side:
                    vals = [brows[i].get(col) for i in rep.tolist()]
                else:
                    vals = [other.rows[j].get(col)
                            for j in oidx.tolist()]
                src_cache[(cside, col)] = vals
            want = inner.schema.type_of(name)
            msk = np.zeros(tot, np.bool_)
            if want == ColumnType.STRING:
                enc = inner.dicts[name].encode
                arr = np.empty(tot, np.int32)
                for i, v in enumerate(vals):
                    if v is None:
                        arr[i] = -1
                        msk[i] = True
                    else:
                        arr[i] = enc(str(v))
            else:
                dt = (np.bool_ if want == ColumnType.BOOL
                      else np.int32 if want == ColumnType.INT
                      else np.float32)
                arr = np.zeros(tot, dt)
                for i, v in enumerate(vals):
                    if v is None or not isinstance(v, (int, float, bool)):
                        msk[i] = True
                    else:
                        arr[i] = v
            cols[name] = arr
            if msk.any():
                nulls[name] = msk
        return cols, (nulls or None)

    # ---- device-resident join ----------------------------------------------
    #
    # Once the columnar fast path is planned, both sides migrate into
    # stores on self.device (engine/join_lattice.py): per-side sorted
    # stores of (code, ts_rel, flags, packed needed columns), one probe
    # wrapper call per micro-batch (the fused probe + window step, or
    # the probe + insert with one deferrable, stackable fetch of the
    # packed match buffer), a two-sided eviction on watermark advance,
    # and an epoch rebase instead of the host store's span abort. The
    # host stores stay the equivalence-reference path
    # (use_device_join=False).

    DEVICE_STORE_CAPACITY = 1 << 14   # initial per-side slots (grows)
    REBASE_REL_MS = 1 << 30           # re-anchor epoch past this

    def _device_ready(self) -> bool:
        if self._dev is not None:
            return True
        if not self.use_device_join:
            return False
        fast = self._fast_info()
        if fast is None:
            return False
        # the reference degrades a failed activation to the host path
        # (device_fallbacks); the port lets the failure raise, before
        # anything has moved off the host stores
        if FAULTS.active:  # chaos: provoke an activation failure
            FAULTS.point("device.activate")
        return self._activate_device(fast)

    def _activate_device(self, fast: dict) -> bool:
        """Plan per-side column layouts from the fast-path need map and
        migrate the host stores' contents into device stores. Each need
        name stores on every side it can resolve from ('both' = bare
        name with left precedence, stored on both sides with a present
        bit)."""
        from hstream_tpu_torch.engine import join_lattice as jl

        lay: dict[str, list[tuple[str, str]]] = {"l": [], "r": []}
        for name, (cside, col) in fast["need"].items():
            for s in ("l", "r"):
                if cside in (s, "both"):
                    lay[s].append((name, col))
        if max(len(lay["l"]), len(lay["r"])) > jl.JOIN_MAX_COLS:
            self.use_device_join = False  # flags word out of bits
            return False
        cap = self.DEVICE_STORE_CAPACITY
        need = max(len(self._stores["l"]), len(self._stores["r"])) * 2
        cap = round_up_pow2(need, lo=cap)
        cands = [int(st.ts.min()) for st in self._stores.values()
                 if len(st)]
        if self.watermark >= 0:
            cands.append(self.watermark)
        t0 = (min(cands) - self.retention_ms) if cands else None
        sjl = None
        if self.mesh is not None and self.mesh.shape["key"] > 1:
            from hstream_tpu_torch.parallel.lattice import ShardedJoinLattice

            # per-shard capacity keeps the single-card formula: the worst
            # key distribution lands every entry on one shard, so this
            # trades memory (n_shards x) for never growing on skew
            sjl = ShardedJoinLattice(self.mesh, len(lay["l"]), len(lay["r"]))
        self._dev = {
            "lay": lay,
            "cap": cap,
            "sjl": sjl,
            "t0": t0,
            "n": {"l": 0, "r": 0},
            # match buffers start small and stick at the pow2 the
            # workload's match totals actually need (the host shadow
            # sizes them EXACTLY per batch, so they never overflow)
            "match_cap": 4096,
            "evict_cutoff": -(1 << 62),
            "stores": {s: (sjl.init_store(s, cap) if sjl is not None else
                           jl.init_join_store(cap, len(lay[s]), self.device))
                       for s in ("l", "r")},
            # the other store of each side, which the kernels write
            # (None: allocate one when needed, _store_out)
            "spare": {"l": None, "r": None},
            # host shadow of each side's (code, ts) multiset, pruned at
            # the probe cutoff: gives EXACT match totals before every
            # launch (match buffers never overflow, the fused kernel can
            # never silently truncate) for the cost of a rowless numpy
            # insert + searchsorted per batch
            "shadow": {"l": _FlatIntervalStore(self._jcode_rev),
                       "r": _FlatIntervalStore(self._jcode_rev)},
        }
        try:
            self._dev["feed"] = self._build_feed_plans()
            for s in ("l", "r"):
                self._migrate_store(s)
        except Exception:
            # a failed migration leaves the host stores as they were and
            # raises: nothing moves to the device half-done
            self._dev = None
            raise
        for s in ("l", "r"):
            self._stores[s] = _FlatIntervalStore(self._jcode_rev)
        return True

    def _build_feed_plans(self) -> dict | None:
        """Hashable per-side plans mapping the inner step's needed
        columns (and null masks) onto match sources, for the fused
        probe -> aggregate call. None when the inner executor is not a
        window lattice (stateless joins keep the match-fetch path), or
        when the plans pass the probe's feed tables (JOIN_MAX_FEED
        columns, JOIN_MAX_NULLS masks, JOIN_MAX_REFS references)."""
        from hstream_tpu_torch.engine.expr import columns_of
        from hstream_tpu_torch.engine.kernels import binding as kb
        from hstream_tpu_torch.engine.lattice import layout_tag

        inner = self._inner
        if (getattr(inner, "spec", None) is None
                or not hasattr(inner, "_null_specs")):
            return None
        if ((self._dev.get("sjl") is not None)
                != (getattr(inner, "_sharded", None) is not None)):
            # a sharded join fuses only into a sharded inner lattice and
            # single-card stores only into a single-card one; a mismatch
            # takes the match-fetch path (join.py:1233-1237)
            return None
        lay_idx = {s: {name: j for j, (name, _c)
                       in enumerate(self._dev["lay"][s])}
                   for s in ("l", "r")}
        plans: dict[str, tuple] = {}
        for side in ("l", "r"):
            other = "r" if side == "l" else "l"

            def entry(name):
                cside, _col = self._fast["need"][name]
                jm = lay_idx[side].get(name, -1)
                jo = lay_idx[other].get(name, -1)
                if cside == side:
                    return ("m", jm, jo)
                if cside == other:
                    return ("o", jm, jo)
                # bare name, left precedence: the SQL left side is the
                # probing batch when side == "l", else the probed store
                return ("both" if side == "l" else "both_o", jm, jo)

            feed = tuple(
                (name, layout_tag(inner.schema.type_of(name)))
                + entry(name)
                for name in self._fast["need"])
            nulls_plan = tuple(
                (key, tuple(entry(c) for c in refs))
                for key, refs in inner._null_specs)
            filter_nulls = (tuple(
                entry(c) for c in sorted(columns_of(inner._filter_expr)))
                if inner._filter_expr is not None else ())
            refs = sum(len(r) for _, r in nulls_plan) + len(filter_nulls)
            if (len(feed) > kb.JOIN_MAX_FEED
                    or len(nulls_plan) > kb.JOIN_MAX_NULLS
                    or refs > kb.JOIN_MAX_REFS):
                # past the probe's feed tables: the match-fetch path
                # (the inner executor's own step) takes the query
                return None
            plans[side] = (feed, nulls_plan, filter_nulls)
        return plans

    def _migrate_store(self, side: str) -> None:
        """Move one host store's live entries into the device store
        (activation): pack host rows into the device entry layout and
        build the tensors directly, already (code, ts) sorted, so no
        kernel runs."""
        from hstream_tpu_torch.engine import join_lattice as jl

        st = self._stores[side]
        n = len(st)
        if n == 0:
            return
        dev = self._dev
        if int(st.ts.max()) - dev["t0"] >= (1 << 31):
            # the host store's span guard allows 2^41 ms but the device
            # store's relative space is int32: a silent wrap here would
            # corrupt every probe bound
            raise SQLCodegenError(
                "join store spans more than the int32 relative range "
                "at device activation; reduce within/grace retention")
        dev["shadow"][side].insert_sorted(
            st.code.copy(), st.ts.copy(), np.empty(n, object))
        lay = dev["lay"][side]
        flags, vals = self._encode_join_cols(
            lay, [st.rows[i] for i in range(n)])
        cap = dev["cap"]
        sjl = dev.get("sjl")
        if sjl is not None:
            # each entry into its owning shard's store; each residue class
            # of a (code, ts)-sorted sequence is itself sorted, so a
            # shard's order needs no sort
            ns = sjl.n_shards
            scode = np.full((ns, cap), jl.JOIN_SENT_CODE, np.int32)
            sts = np.zeros((ns, cap), np.int32)
            sfl = np.zeros((ns, cap), np.int32)
            scv = np.zeros((ns, len(lay), cap), np.int32)
            cls = (st.code % ns).astype(np.int64)
            for s in range(ns):
                m = np.nonzero(cls == s)[0]
                k = len(m)
                scode[s, :k] = st.code[m].astype(np.int32)
                sts[s, :k] = (st.ts[m] - dev["t0"]).astype(np.int32)
                sfl[s, :k] = flags[m]
                scv[s, :, :k] = vals[:, m]
            dev["stores"][side] = sjl.put_store(
                {"code": scode, "ts": sts, "flags": sfl, "cols": scv})
            dev["n"][side] = n
            return
        code = np.full(cap, jl.JOIN_SENT_CODE, np.int32)
        code[:n] = st.code.astype(np.int32)
        ts = np.zeros(cap, np.int32)
        ts[:n] = (st.ts - dev["t0"]).astype(np.int32)
        f32 = np.zeros(cap, np.int32)
        f32[:n] = flags
        cv = np.zeros((len(lay), cap), np.int32)
        cv[:, :n] = vals
        dev["stores"][side] = {
            k: torch.from_numpy(v).to(self.device)
            for k, v in (("code", code), ("ts", ts), ("flags", f32),
                         ("cols", cv))}
        dev["n"][side] = n

    def _encode_join_cols(self, lay, rows) -> tuple[np.ndarray,
                                                    np.ndarray]:
        """Pack one side's needed columns for a list of rows into
        (flags i32[n], values i32[len(lay), n]): 2 bits per column in
        flags (bit 2j = SQL NULL / non-scalar, bit 2j+1 = field
        present), values f32-bitcast / i32 / bool / dictionary id —
        the same per-value rules as the host fast path (_match_cols)."""
        from hstream_tpu_torch.engine.types import ColumnType

        inner = self._inner
        n = len(rows)
        flags = np.zeros(n, np.int32)
        vals = np.zeros((len(lay), n), np.int32)
        for j, (name, col) in enumerate(lay):
            nullb = np.int32(1 << (2 * j))
            presb = np.int32(1 << (2 * j + 1))
            want = inner.schema.type_of(name)
            if want == ColumnType.STRING:
                enc = inner.dicts[name].encode
                arr = np.zeros(n, np.int32)
                for i, r in enumerate(rows):
                    v = r.get(col, _MISS)
                    if v is _MISS:
                        flags[i] |= nullb
                    elif v is None:
                        flags[i] |= nullb | presb
                    else:
                        arr[i] = enc(str(v))
                        flags[i] |= presb
                vals[j] = arr
            else:
                dt = (np.bool_ if want == ColumnType.BOOL
                      else np.int32 if want == ColumnType.INT
                      else np.float32)
                arr = np.zeros(n, dt)
                for i, r in enumerate(rows):
                    v = r.get(col, _MISS)
                    if v is _MISS:
                        flags[i] |= nullb
                    elif v is None or not isinstance(v, (int, float,
                                                         bool)):
                        flags[i] |= nullb | presb
                    else:
                        arr[i] = v
                        flags[i] |= presb
                vals[j] = (arr.view(np.int32) if dt is np.float32
                           else arr.astype(np.int32))
        return flags, vals

    # ---- columnar ingest (vectorized encode, no row dicts) ----------------

    def _columnar_batch(self, side, my_keys, ts, cols, nulls):
        """Vectorized (codes, bts, flags, vals) in (code, ts) sorted
        order for a columnar batch, or None when this batch cannot
        encode columnar (non-Col ON keys, untyped columns) — the
        caller materializes rows once and takes the row path."""
        t = time.perf_counter()
        codes = self._batch_codes_columnar(my_keys, cols, nulls,
                                           len(ts))
        if codes is None:
            return None
        enc = self._encode_join_cols_columnar(
            self._dev["lay"][side], cols, nulls, len(ts))
        t1 = time.perf_counter()
        self.stage_stats["key_encode_s"] += t1 - t
        if enc is None:
            return None
        flags, vals = enc
        keep = codes >= 0
        if not keep.all():
            kidx = np.nonzero(keep)[0]
            codes = codes[kidx]
            bts = ts[kidx]
            flags = flags[kidx]
            vals = vals[:, kidx]
        else:
            bts = ts
        if not len(codes):
            return codes, bts, flags, vals
        order = np.lexsort((bts, codes))
        out = (codes[order], bts[order], flags[order], vals[:, order])
        self.stage_stats["lexsort_s"] += time.perf_counter() - t1
        return out

    def _batch_codes_columnar(self, my_keys, cols, nulls,
                              n: int) -> np.ndarray | None:
        """Dense join-key codes for a columnar batch: unique + encode
        per DISTINCT value, one gather per row — the vectorized twin of
        _batch_codes. None = fall back to the row path."""
        if not all(isinstance(e, Col) for e in my_keys):
            return None
        # compact BEFORE encoding, like _batch_codes
        if len(self._jcode_rev) + n >= (1 << 22) - 1:
            self._compact_codes()
            if len(self._jcode_rev) + n >= (1 << 22) - 1:
                raise SQLCodegenError(
                    "join key cardinality within the retention window "
                    f"exceeds {1 << 22} distinct keys")
        jcode = self._jcode
        rev = self._jcode_rev

        def code_of(k) -> int:
            c = jcode.get(k)
            if c is None:
                c = len(rev)
                jcode[k] = c
                rev.append(k)
            return c

        col_vals: list[np.ndarray] = []
        col_codes: list[np.ndarray] = []
        null_any = np.zeros(n, np.bool_)
        for e in my_keys:
            arr = cols.get(e.name)
            if arr is None:
                return None if n else np.empty(0, np.int64)
            nm = nulls.get(e.name) if nulls else None
            if nm is not None:
                null_any |= nm
            try:
                uniq, inv = np.unique(np.asarray(arr),
                                      return_inverse=True)
            except TypeError:
                return None  # incomparable mixed values: row path
            col_vals.append(uniq)
            col_codes.append(inv.astype(np.int64))
        if len(my_keys) == 1:
            uniq = col_vals[0]
            lut = np.fromiter(
                (code_of(canon_key((v,))) for v in uniq.tolist()),
                np.int64, len(uniq))
            out = lut[col_codes[0]]
        else:
            combined = col_codes[0]
            for inv, uniq in zip(col_codes[1:], col_vals[1:]):
                combined = combined * len(uniq) + inv
            u, uinv = np.unique(combined, return_inverse=True)
            lut = np.empty(len(u), np.int64)
            for i, cu in enumerate(u.tolist()):
                idxs = []
                for uniq in reversed(col_vals[1:]):
                    idxs.append(cu % len(uniq))
                    cu //= len(uniq)
                idxs.append(cu)
                idxs.reverse()
                key = tuple(col_vals[k][i2].item()
                            if hasattr(col_vals[k][i2], "item")
                            else col_vals[k][i2]
                            for k, i2 in enumerate(idxs))
                lut[i] = code_of(canon_key(key))
            out = lut[uinv]
        if null_any.any():
            out = np.where(null_any, -1, out)
        return out

    def _encode_join_cols_columnar(self, lay, cols, nulls, n: int):
        """Vectorized twin of _encode_join_cols over whole columns:
        (flags i32[n], vals i32[len(lay), n]), or None when a column's
        dtype cannot encode without per-row inspection."""
        from hstream_tpu_torch.engine.types import ColumnType

        inner = self._inner
        flags = np.zeros(n, np.int32)
        vals = np.zeros((len(lay), n), np.int32)
        for j, (name, col) in enumerate(lay):
            nullb = np.int32(1 << (2 * j))
            presb = np.int32(1 << (2 * j + 1))
            arr = cols.get(col)
            if arr is None:
                flags |= nullb  # field absent from every record
                continue
            arr = np.asarray(arr)
            nm = nulls.get(col) if nulls else None
            want = inner.schema.type_of(name)
            if want == ColumnType.STRING:
                enc = inner.dicts[name].encode
                try:
                    uniq, inv = np.unique(arr, return_inverse=True)
                except TypeError:
                    return None
                lut = np.fromiter((enc(str(v)) for v in uniq.tolist()),
                                  np.int32, len(uniq))
                vals[j] = lut[inv]
                row_flags = presb
            else:
                if arr.dtype == object or arr.dtype.kind in ("U", "S"):
                    return None  # untyped numerics: row path decides
                try:
                    if want == ColumnType.FLOAT:
                        vals[j] = arr.astype(
                            np.float32, copy=False).view(np.int32)
                    elif want == ColumnType.BOOL:
                        vals[j] = (np.asarray(arr) != 0).astype(
                            np.int32)
                    else:
                        vals[j] = arr.astype(np.int32)
                except (TypeError, ValueError):
                    return None
                row_flags = presb
            flags |= row_flags
            if nm is not None and nm.any():
                # a null-masked cell is an ABSENT field (drop_null row
                # parity): null bit on, present bit off, value zeroed
                flags[nm] = (flags[nm] | nullb) & ~presb
                vals[j, nm] = 0
        return flags, vals

    @staticmethod
    def _rows_from_cols(cols, nulls, n: int) -> list[dict[str, Any]]:
        """Materialize columnar input into per-row dicts (fallback /
        host reference path) with null-masked cells dropped — the same
        row shape the per-record decode produces, including
        columnar.to_rows' f64 parity (integral doubles decode as ints,
        like Struct number decoding)."""
        host = {}
        masks = {}
        for name, arr in cols.items():
            if isinstance(arr, np.ndarray) and arr.dtype == np.float64:
                vals = [int(v) if v.is_integer() else v
                        for v in arr.tolist()]
            elif isinstance(arr, np.ndarray):
                vals = arr.tolist()
            else:
                vals = list(arr)
            nm = nulls.get(name) if nulls else None
            if nm is not None and nm.any():
                masks[name] = nm.tolist()
            host[name] = vals
        names = list(host)
        if not names:
            return [{} for _ in range(n)]
        rows = [dict(zip(names, vv))
                for vv in zip(*(host[c] for c in names))]
        for name, mask in masks.items():
            for row, isnull in zip(rows, mask):
                if isnull:
                    del row[name]
        return rows


    def _store_out(self, side: str):
        """The store the next kernel writing `side` fills: the side's
        spare, or a fresh one when there is none of the current size.
        None on the CPU, where the plain versions return new tensors."""
        from hstream_tpu_torch.engine import join_lattice as jl

        if self.device.type == "cpu":
            return None
        dev = self._dev
        out, dev["spare"][side] = dev["spare"][side], None
        sjl = dev.get("sjl")
        if sjl is not None:
            if out is None or out[0]["code"].shape[0] != dev["cap"]:
                out = sjl.empty_store(side, dev["cap"])
            return out
        if out is None or out["code"].shape[0] != dev["cap"]:
            out = jl.empty_join_store(dev["cap"], len(dev["lay"][side]),
                                      self.device)
        return out

    def _swap(self, side: str, new) -> None:
        """Install a side's new store; the replaced one becomes its spare
        unless a deferred match buffer still refers to it as the store
        it probed (a re-probe must find it unchanged)."""
        dev = self._dev
        old, dev["stores"][side] = dev["stores"][side], new
        if self.device.type != "cpu" and not any(
                p[5] is old for p in self._pending_matches):
            dev["spare"][side] = old

    def _device_batch(self, side, codes, bts, flags, vals
                      ) -> list[dict[str, Any]]:
        """One micro-batch on the device path: pack, upload, ONE probe
        wrapper call. When the downstream aggregate can fuse, the call
        steps the matched pairs straight into the inner lattice (matches
        never leave the device); otherwise the packed match buffer is
        the one (deferrable, stackable) D2H fetch. `flags` / `vals` are
        the side's pre-encoded entry columns in (code, ts) sorted order
        (row or columnar encoder). The batch is sized to the records
        (bcap = n): the kernels take any width."""
        from hstream_tpu_torch.engine import join_lattice as jl

        dev = self._dev
        st = self.stage_stats
        n = len(codes)
        if dev["t0"] is None:
            dev["t0"] = int(bts.min()) - self.retention_ms
        self._maybe_rebase(int(bts.min()), int(bts.max()))
        if dev["n"][side] + n > dev["cap"]:
            self._refresh_counts()  # upper bound -> exact
        if dev["n"][side] + n > dev["cap"]:
            # capacity pressure: evict with the PRE-batch watermark
            # cutoff; the probe below must still see every entry the
            # host reference would (it prunes only after the batch)
            self._dispatch_evict(self.watermark - self.retention_ms, 0)
            self._refresh_counts()
            if dev["n"][side] + n > dev["cap"]:
                self._grow_device(round_up_pow2(
                    dev["n"][side] + n, lo=dev["cap"] * 2))
            elif max(dev["n"].values()) + n > dev["cap"] // 2:
                # hysteresis: an eviction that leaves the store more
                # than half full would force another compaction within a
                # few batches; grow once instead of evicting every batch
                self._grow_device(dev["cap"] * 2)
        # exact match total from the host shadow (code/ts only): sizes
        # the match width so the kernel can never truncate
        t = time.perf_counter()
        other_side = "r" if side == "l" else "l"
        cutoff_abs = (self.watermark - self.retention_ms
                      if self.watermark >= 0 else None)
        shadow_o = dev["shadow"][other_side]
        lo_ts = bts - self.within
        if cutoff_abs is not None:
            lo_ts = np.maximum(lo_ts, cutoff_abs)
        pr = shadow_o.probe(codes, lo_ts, bts + self.within)
        sjl = dev.get("sjl")
        if pr is None:
            total = 0
        elif sjl is not None:
            # the match buffer is PER SHARD: sized to the worst shard's
            # total (each shard packs its own segment)
            total = int(np.bincount(
                (codes % sjl.n_shards).astype(np.int64),
                weights=(pr[1] - pr[0]).astype(np.float64),
                minlength=sjl.n_shards).max())
        else:
            total = int((pr[1] - pr[0]).sum())
        dev["shadow"][side].insert_sorted(codes, bts,
                                          np.empty(n, object))
        if cutoff_abs is not None and cutoff_abs > 0:
            dev["shadow"][side].prune(cutoff_abs)
            shadow_o.prune(cutoff_abs)
        if total > dev["match_cap"]:
            dev["match_cap"] = round_up_pow2(total,
                                             lo=dev["match_cap"] * 2)
        t1 = time.perf_counter()
        st["shadow_s"] += t1 - t
        kid = self._match_key_ids(codes)
        lay = dev["lay"][side]
        buf = np.empty((4 + len(lay), n), np.int32)
        buf[0] = codes
        buf[1] = bts - dev["t0"]
        buf[2] = kid
        buf[3] = flags
        if len(lay):
            buf[4:] = vals
        t2 = time.perf_counter()
        st["pack_s"] += t2 - t1
        bt = torch.from_numpy(buf).to(self.device)
        st["h2d_s"] += time.perf_counter() - t2
        other = dev["stores"][other_side]
        # the probe-visible retention cutoff mirrors the host
        # reference's prune-before-this-batch state: the device store
        # may still hold older entries (eviction is lazy, capacity
        # only), but matches must not see them
        cutoff = int(np.clip(
            (cutoff_abs - dev["t0"]) if cutoff_abs is not None
            else -(1 << 31), -(1 << 31), (1 << 31) - 1))
        self.join_stats["probe_batches"] += 1
        self.join_stats["probe_dispatches"] += 1
        if dev.get("feed") is not None and self._fuse_ok(bts):
            return self._fused_batch(side, other_side, bt, buf, n, cutoff)
        with kernel_family("probe", self.dispatch_observer,
                           ready=self._device_values):
            if sjl is not None:
                new, packed = sjl.probe_insert(
                    side, dev["stores"][side], other, bt, n, self.within,
                    cutoff, match_cap=dev["match_cap"],
                    out=self._store_out(side))
                self._sharded_dispatches += 1
            else:
                new, packed = jl.join_probe_insert(
                    dev["stores"][side], other, bt, n, self.within, cutoff,
                    dev["match_cap"], len(lay), out=self._store_out(side))
        self._swap(side, new)
        self._note_insert(side, n)
        # the pending entry keeps (batch, probed store) alive so a
        # truncated match buffer could re-probe wider (unreachable
        # while the shadow sizes the width, kept as belt-and-braces)
        self._pending_matches.append(
            (packed, side, dev["t0"], bt, n, other, cutoff))
        if len(self._pending_matches) >= max(self.match_drain_depth, 1):
            return self._drain_matches()
        return []

    # ---- fused probe -> inner aggregate (zero per-batch D2H) --------------

    def _fuse_ok(self, bts) -> bool:
        """Whether this batch can take the fully fused kernel: the
        inner executor's host window bookkeeping must be able to track
        the conservative joined-ts range [min bts, max bts + within]
        without a per-row scan — the windows-in-range set must fit the
        fast gate and introduce no slot aliasing (mirrors _gap_guard's
        collision check; a batch that fails falls back to the
        match-fetch path, which runs the full guard)."""
        inner = self._inner
        w = inner.window
        if w is None:
            return True
        if inner.epoch is not None and int(bts.min()) < inner.epoch:
            return False  # pre-epoch joined ts: row path handles
        adv = w.advance_ms
        lo = int(bts.min())
        hi = int(bts.max()) + self.within
        span = (hi - hi % adv - (lo - lo % adv)) // adv + 1
        back = w.windows_per_record - 1
        if span + back > min(inner.spec.n_slots, 64):
            return False
        period = adv * inner.spec.n_slots
        starts = np.arange(lo - lo % adv - back * adv,
                           hi - hi % adv + adv, adv)
        if inner.watermark_abs >= 0:
            starts = starts[starts + w.size_ms + w.grace_ms
                            > inner.watermark_abs]
        cand = set(starts.tolist()) | set(inner._open)
        by_res: dict[int, int] = {}
        for s in cand:
            r = s % period
            if r in by_res and by_res[r] != s:
                return False  # slot aliasing: let _gap_guard handle it
            by_res[r] = s
        return True


    def _fused_batch(self, side, other_side, bt, buf, n, cutoff
                     ) -> list[dict[str, Any]]:
        """The fused call: probe, step every matched pair into the inner
        lattice, insert (join_probe_insert_step). The batch costs ZERO
        D2H; the changelog extract (already deferred/batched) is the
        only fetch left on the join's hot path."""
        from hstream_tpu_torch.engine import join_lattice as jl

        dev = self._dev
        inner = self._inner
        lo = int(buf[1].min()) + dev["t0"]
        hi = int(buf[1].max()) + dev["t0"] + self.within
        inner._ensure_epoch(lo)
        inner._maybe_rebase(hi)
        # watermark forwarding: the joined stream's watermark is the
        # JOIN's watermark (both paths apply the same sync in
        # _feed_inner_columnar, so late-mask semantics stay identical)
        if self.watermark > inner.watermark_abs:
            inner.watermark_abs = self.watermark
        wm_rel = (max(inner.watermark_abs - inner.epoch, -1)
                  if inner.watermark_abs >= 0 else -1)
        ts_off = dev["t0"] - inner.epoch
        inner.read_epoch += 1
        sjl = dev.get("sjl")
        with kernel_family("probe", self.dispatch_observer,
                           ready=self._device_values):
            if sjl is not None:
                feed, nulls_plan, filter_nulls = dev["feed"][side]
                new, inner.state, _total = sjl.probe_insert_step(
                    side, inner._sharded, dev["stores"][side],
                    dev["stores"][other_side], bt, n, self.within, cutoff,
                    inner.state, wm_rel, ts_off, feed_plan=feed,
                    nulls_plan=nulls_plan, filter_nulls=filter_nulls,
                    match_cap=dev["match_cap"], out=self._store_out(side))
                self._sharded_dispatches += 1
            else:
                new, _total = jl.join_probe_insert_step(
                    dev["stores"][side], dev["stores"][other_side], bt, n,
                    self.within, cutoff, dev["match_cap"],
                    len(dev["lay"][side]), inner.spec, inner.state, wm_rel,
                    ts_off, inner._progs, dev["feed"][side],
                    out=self._store_out(side))
        self._swap(side, new)
        self._note_insert(side, n)
        self.join_stats["fused_batches"] += 1
        # inner host bookkeeping over the conservative ts range (the
        # overapproximated window set is semantics-free: empty windows
        # close without emitting via the count>0 filter)
        try:
            if inner.window is not None:
                inner._track_windows(np.asarray([lo, hi], np.int64))
            bmax = hi - self.within  # this batch's max record ts
            if bmax > inner.watermark_abs:
                inner.watermark_abs = bmax
            out = None
            if inner.emit_changes:
                out = extend_rows(out, inner._drain_changes())
            out = extend_rows(out, inner.close_due_windows())
            # a lone ColumnarEmit rides through unmaterialized: the
            # fused path must not be the one place rows re-dictify
            return out if out is not None else []
        finally:
            inner._no_close.clear()
            inner._touched_this_call.clear()

    def _drain_matches(self) -> list[dict[str, Any]]:
        """Fetch + decode every pending match buffer: buffers of one
        shape stack into ONE device->host transfer (fetch count, not
        bytes, dominates on real links), then decode columnar and feed
        the inner executor."""
        from hstream_tpu_torch.engine.lattice import stack_pow2

        if not self._pending_matches:
            return []
        pending, self._pending_matches = self._pending_matches, []
        # piggyback the deferred post-eviction counts on this sync:
        # everything queued ahead of the match buffers has executed by
        # the time they arrive, so the 2-int copy is free here
        self._refresh_counts()
        host: list[tuple] = []
        if len(pending) == 1:
            packed, *rest = pending[0]
            self.join_stats["probe_fetches"] += 1
            host.append((packed.cpu().numpy(), *rest))
        else:
            by_shape: dict[tuple, list] = {}
            for ent in pending:
                by_shape.setdefault(tuple(ent[0].shape), []).append(ent)
            groups: dict[int, tuple] = {}
            for group in by_shape.values():
                self.join_stats["probe_fetches"] += 1
                stacked = stack_pow2([e[0] for e in group]).cpu().numpy()
                for ent, hbuf in zip(group, stacked):
                    groups[id(ent)] = (hbuf, *ent[1:])
            # preserve submission order across shape groups
            host = [groups[id(ent)] for ent in pending]
        out = None
        sjl = self._dev.get("sjl")
        for hbuf, side, t0, buf, n, other, cutoff in host:
            nm = len(self._dev["lay"][side])
            if sjl is not None:
                # per-shard headers sit at column s * match_cap; any
                # shard's truncation forces the whole buffer's redo
                width = hbuf.shape[1] // sjl.n_shards
                total = max(int(hbuf[0, s * width])
                            for s in range(sjl.n_shards))
            else:
                total = int(hbuf[0, 0])
                width = hbuf.shape[1]
            if total > width:
                hbuf = self._reprobe_wider(side, buf, n, other, cutoff,
                                           total)
            out = extend_rows(out, self._decode_matches(side, t0, hbuf,
                                                        nm))
        return out if out is not None else []

    def _reprobe_wider(self, side, buf, n, other, cutoff,
                       total) -> np.ndarray:
        """Match-overflow redo: probe-only at the next pow2 width (the
        batch is already inserted; `other` is the exact store the first
        probe read, `cutoff` its retention mask)."""
        from hstream_tpu_torch.engine import join_lattice as jl

        dev = self._dev
        match_cap = round_up_pow2(total, lo=dev["match_cap"] * 2)
        dev["match_cap"] = max(dev["match_cap"], match_cap)
        self.join_stats["match_redispatches"] += 1
        self.join_stats["probe_fetches"] += 1
        sjl = dev.get("sjl")
        if sjl is not None:
            self._sharded_dispatches += 1
            return sjl.probe_only(side, other, buf, n, self.within, cutoff,
                                  match_cap).cpu().numpy()
        return jl.join_probe_only(other, buf, n, self.within, cutoff,
                                  match_cap,
                                  len(dev["lay"][side])).cpu().numpy()

    def _decode_matches(self, side, t0, hbuf, nm
                        ) -> list[dict[str, Any]]:
        """Columnar decode of a fetched match buffer into the inner
        step's input: resolve each needed column from the probe/stored
        side (left precedence for bare names via the present bits), the
        vectorized twin of _match_cols."""
        from hstream_tpu_torch.engine import join_lattice as jl
        from hstream_tpu_torch.engine.types import ColumnType

        sjl = self._dev.get("sjl") if self._dev is not None else None
        if sjl is not None:
            total, kid, jts, mflags, oflags, mcols, ocols = \
                sjl.unpack_matches(hbuf, side)
        else:
            total, kid, jts, mflags, oflags, mcols, ocols = \
                jl.unpack_join_matches(hbuf, nm)
        m = len(kid)
        if m == 0:
            return []
        dev = self._dev
        other_side = "r" if side == "l" else "l"
        lidx = {name: j for j, (name, _c)
                in enumerate(dev["lay"]["l"])}
        ridx = {name: j for j, (name, _c)
                in enumerate(dev["lay"]["r"])}
        phys = {side: (mflags, mcols), other_side: (oflags, ocols)}
        inner = self._inner
        cols: dict[str, np.ndarray] = {}
        nulls: dict[str, np.ndarray] = {}
        for name, (cside, _col) in self._fast["need"].items():
            if cside == "both":
                lf, lv = phys["l"]
                rf, rv = phys["r"]
                lj, rj = lidx[name], ridx[name]
                lpres = ((lf >> (2 * lj + 1)) & 1).astype(np.bool_)
                val = np.where(lpres, lv[lj], rv[rj])
                nb = np.where(lpres, (lf >> (2 * lj)) & 1,
                              (rf >> (2 * rj)) & 1)
            else:
                f, v = phys[cside]
                j = lidx[name] if cside == "l" else ridx[name]
                val = v[j]
                nb = (f >> (2 * j)) & 1
            want = inner.schema.type_of(name)
            if want == ColumnType.FLOAT:
                cols[name] = np.ascontiguousarray(
                    val, np.int32).view(np.float32)
            elif want == ColumnType.BOOL:
                cols[name] = val != 0
            else:
                cols[name] = np.ascontiguousarray(val, np.int32)
            msk = nb.astype(np.bool_)
            if msk.any():
                nulls[name] = msk
        return self._feed_inner_columnar(
            kid.astype(np.int32), jts.astype(np.int64) + t0, cols,
            nulls or None)

    def _maybe_rebase(self, min_ts: int, max_ts: int) -> None:
        """Keep device-relative time inside int32: re-anchor the join
        epoch down when an in-grace batch reaches below it, up when
        stream time approaches the threshold — the rebase rides the
        two-sided eviction kernel (delta arg), so it costs one rare
        dispatch instead of the host store's span abort."""
        dev = self._dev
        # the eviction riding the rebase runs BEFORE this batch's
        # probe, so its cutoff is the PRE-batch watermark's — exactly
        # the prune state the host reference would probe against
        cutoff_abs = ((self.watermark - self.retention_ms)
                      if self.watermark >= 0 else dev["t0"])
        if min_ts - dev["t0"] < 0:
            delta = (min_ts - self.retention_ms) - dev["t0"]
        elif max_ts - dev["t0"] >= self.REBASE_REL_MS:
            delta = max(cutoff_abs - dev["t0"], 0)
        else:
            return
        if max_ts - (dev["t0"] + delta) >= (1 << 31):
            # the span guard must fire even when retention pins the
            # epoch (delta == 0) — silently wrapping int32 relative
            # time would corrupt probe bounds
            raise SQLCodegenError(
                "join record timestamps span more than the int32 "
                "relative range even after epoch rebase; timestamps "
                "must be epoch milliseconds")
        if delta == 0:
            return
        self._dispatch_evict(cutoff_abs, delta)
        self.join_stats["rebase_dispatches"] += 1

    def _maybe_evict(self, cutoff_abs: int) -> None:
        """Watermark-advance eviction policy: dispatch the two-sided
        compaction once retention has advanced a full span past the
        last one AND the stores hold enough dead weight to be worth a
        sort (capacity pressure dispatches it unconditionally in
        _device_batch)."""
        dev = self._dev
        if cutoff_abs - dev["evict_cutoff"] < max(self.retention_ms, 1):
            return
        if dev["n"]["l"] + dev["n"]["r"] < dev["cap"] // 2:
            # mostly-empty stores: skip the sort, just note progress
            dev["evict_cutoff"] = cutoff_abs
            return
        self._dispatch_evict(cutoff_abs, 0)


    def _dispatch_evict(self, cutoff_abs: int, delta: int) -> None:
        """One two-sided eviction (+ rebase) call. The live counts stay
        a DEVICE value (dev["pending_n"]) so the hot loop never blocks on
        them; host-side dev["n"] remains a safe upper bound (eviction
        only shrinks) and _refresh_counts() forces the tiny fetch only
        when a capacity decision needs exact numbers."""
        from hstream_tpu_torch.engine import join_lattice as jl

        dev = self._dev
        cutoff_rel = max(cutoff_abs - dev["t0"], 0)
        out = ([self._store_out("l"), self._store_out("r")]
               if self.device.type != "cpu" else None)
        sjl = dev.get("sjl")
        if sjl is not None:
            left, right, narr = sjl.evict(
                dev["stores"]["l"], dev["stores"]["r"],
                min(cutoff_rel, (1 << 31) - 1), delta, out=out)
            self._sharded_dispatches += 1
        else:
            left, right, narr = jl.join_evict(
                dev["stores"]["l"], dev["stores"]["r"],
                min(cutoff_rel, (1 << 31) - 1), delta, out=out)
        self._swap("l", left)
        self._swap("r", right)
        # the deferred count snapshot reflects the store AT THIS call;
        # inserts queued after it must be re-added when the snapshot is
        # finally read (_refresh_counts), or the capacity upper bound
        # would undercount and let the insert drop live entries
        dev["pending_n"] = (narr, {"l": 0, "r": 0})
        dev["t0"] += delta
        dev["evict_cutoff"] = max(dev["evict_cutoff"], cutoff_abs)
        self.join_stats["evict_dispatches"] += 1

    def _note_insert(self, side: str, n: int) -> None:
        """Count an insert against the host bound AND any in-flight
        eviction snapshot."""
        dev = self._dev
        dev["n"][side] += n
        pend = dev.get("pending_n")
        if pend is not None:
            pend[1][side] += n


    def _refresh_counts(self) -> None:
        """Force the deferred post-eviction live counts (2-int fetch),
        re-adding inserts made after the eviction."""
        dev = self._dev
        pend = dev.pop("pending_n", None)
        if pend is not None:
            narr, since = pend
            n = narr.cpu().numpy()
            if n.ndim == 2:       # key shards: [n_shards, 2]
                n = n.sum(axis=0)
            dev["n"] = {"l": int(n[0]) + since["l"],
                        "r": int(n[1]) + since["r"]}

    def _grow_device(self, new_cap: int) -> None:
        """Grow a full store pair: pad every plane with empty slots
        (code sentinel, ts 0) on the device; rare, host-driven."""
        from hstream_tpu_torch.engine import join_lattice as jl

        dev = self._dev
        extra = new_cap - dev["cap"]

        def grown(st):
            pad = jl.init_join_store(extra, st["cols"].shape[0],
                                     st["code"].device)
            return {k: torch.cat([st[k], pad[k]], dim=-1).contiguous()
                    for k in st}

        for s in ("l", "r"):
            st = dev["stores"][s]
            dev["stores"][s] = ([grown(x) for x in st]
                                if isinstance(st, list) else grown(st))
            dev["spare"][s] = None
        dev["cap"] = new_cap
        self.join_stats["store_grows"] += 1

    def _remap_device_codes(self, new_of_old: np.ndarray) -> None:
        """Apply a code-space compaction to the device stores, in place:
        live codes keep their sorted order under the dense compaction,
        so a gather through the remap table suffices (no re-sort); codes
        at or above the table (the sentinel) map to the sentinel. The
        session remap kernel with its sentinel flag."""
        from hstream_tpu_torch.engine import session_lattice as sl

        lut = torch.from_numpy(new_of_old.astype(np.int32)).to(self.device)
        for s in ("l", "r"):
            st = self._dev["stores"][s]
            for shard in (st if isinstance(st, list) else [st]):
                sl.session_remap(shard, lut.to(shard["code"].device),
                                 sent_above=True)

    def _host_store_view(self) -> dict[str, "_FlatIntervalStore"]:
        """The two side stores as host _FlatIntervalStores (snapshot
        serialization, equivalence tests; join.py:2117-2215 in the
        reference, its single-chip branch). In device mode both stores
        are fetched, the retention cutoff the probes apply is applied
        (the device store evicts lazily), and each entry's row is rebuilt
        from the packed needed columns: the only fields a future match
        can emit on the fast path."""
        if self._dev is None:
            return self._stores
        from hstream_tpu_torch.engine import join_lattice as jl
        from hstream_tpu_torch.engine.types import ColumnType

        self._refresh_counts()
        out: dict[str, _FlatIntervalStore] = {}
        inner = self._inner
        cutoff = (self.watermark - self.retention_ms
                  if self.watermark >= 0 else None)
        for side in ("l", "r"):
            st = _FlatIntervalStore(self._jcode_rev)
            n = self._dev["n"][side]
            if n:
                stores = self._dev["stores"][side]
                if self._dev.get("sjl") is not None:
                    # the per-shard stores flattened into one (code, ts)-
                    # sorted sequence: the live entries are each shard's
                    # non-sentinel slots, the shards interleave in code
                    # order
                    code = np.stack([x["code"].cpu().numpy()
                                     for x in stores])
                    shard, slot = np.nonzero(code < jl.JOIN_SENT_CODE)
                    fl = {k: np.stack([x[k].cpu().numpy() for x in stores])
                          [shard, slot] for k in ("code", "ts", "flags")}
                    cols = np.stack([x["cols"].cpu().numpy()
                                     for x in stores])
                    order = np.lexsort((fl["ts"], fl["code"]))
                    arrs = {k: v[order] for k, v in fl.items()}
                    arrs["cols"] = cols.transpose(1, 0, 2)[
                        :, shard, slot][:, order]
                    n = len(order)
                else:
                    arrs = {k: v.cpu().numpy() for k, v in stores.items()}
                if cutoff is not None:
                    keep = (arrs["ts"][:n].astype(np.int64)
                            + self._dev["t0"]) >= cutoff
                    arrs = {
                        "code": arrs["code"][:n][keep],
                        "ts": arrs["ts"][:n][keep],
                        "flags": arrs["flags"][:n][keep],
                        "cols": arrs["cols"][:, :n][:, keep],
                    }
                    n = int(keep.sum())
                if n == 0:
                    out[side] = st
                    continue
                decoded: list[tuple[str, list]] = []
                flags = arrs["flags"][:n]
                for j, (name, col) in enumerate(self._dev["lay"][side]):
                    want = inner.schema.type_of(name)
                    raw = arrs["cols"][j, :n]
                    nullm = ((flags >> (2 * j)) & 1).astype(np.bool_)
                    presm = ((flags >> (2 * j + 1)) & 1).astype(np.bool_)
                    if want == ColumnType.FLOAT:
                        vv = np.ascontiguousarray(raw).view(np.float32)
                        py = [float(x) for x in vv]
                    elif want == ColumnType.BOOL:
                        py = [bool(x) for x in raw]
                    elif want == ColumnType.STRING:
                        dec = inner.dicts[name].decode
                        py = [dec(int(x)) if not nl else None
                              for x, nl in zip(raw, nullm)]
                    else:
                        py = [int(x) for x in raw]
                    decoded.append((col, [
                        (_MISS if not p else (None if nl else v))
                        for v, nl, p in zip(py, nullm, presm)]))
                rows = np.empty(n, object)
                for i in range(n):
                    row = {}
                    for col, vals in decoded:
                        if vals[i] is not _MISS:
                            row[col] = vals[i]
                    rows[i] = row
                st.insert_sorted(
                    arrs["code"][:n].astype(np.int64),
                    arrs["ts"][:n].astype(np.int64) + self._dev["t0"],
                    rows)
            out[side] = st
        return out

    def device_store_counts(self) -> dict[str, int] | None:
        """Live entries per device store side (tests/introspection)."""
        if self._dev is None:
            return None
        self._refresh_counts()
        return dict(self._dev["n"])
