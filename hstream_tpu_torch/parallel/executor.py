"""Host executor for mesh-sharded queries (the port of
hstream_tpu/parallel/executor.py).

Same host-side semantics as engine.QueryExecutor (watermark, window
bookkeeping, key dictionary, emission); only the device callables differ:
they come from a ShardedLattice, so every process() folds a packed batch
into the shards' partial lattices and the drains merge the partials in
the merged kernels (parallel/lattice.py).
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from hstream_tpu_torch.common.columnar import extend_rows
from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.common.tracing import kernel_family
from hstream_tpu_torch.engine import lattice
from hstream_tpu_torch.engine.executor import QueryExecutor, StagedBatch
from hstream_tpu_torch.engine.plan import AggregateNode
from hstream_tpu_torch.engine.types import Schema, round_up_pow2
from hstream_tpu_torch.parallel.lattice import (
    ShardedLattice,
    ShardedState,
    on,
)


class ShardedQueryExecutor(QueryExecutor):
    """QueryExecutor whose lattice lives sharded over a (data, key) mesh.

    ``initial_keys`` is the fixed GLOBAL key capacity (it must divide by
    the key-axis size). Key growth re-shards through the host, rare as in
    the reference. The executor's `device` is shard (0, 0)'s."""

    # the sharded drains fetch synchronously (one copy of the per-shard
    # stack); the deferral knobs would be silent no-ops
    supports_deferred_changes = False

    def __init__(self, node: AggregateNode, schema: Schema, *, mesh,
                 emit_changes: bool = True, initial_keys: int = 1024,
                 batch_capacity: int = 4096):
        self._mesh = mesh
        # launches of the sharded step and of the changelog drain; the
        # query task mirrors deltas into the sharded_dispatches stat family
        self.sharded_dispatches = 0
        # the packed batch's capacity, as the reference picks it: a power
        # of two from 256 on the row path, and on the columnar path the
        # smallest capacity already used within 8x padding
        self._row_cap = False
        self._caps_used: set[int] = set()
        self._caps_lock = threading.Lock()
        super().__init__(node, schema, emit_changes=emit_changes,
                         initial_keys=initial_keys,
                         batch_capacity=batch_capacity,
                         device=mesh.devices[0, 0])

    def _compile(self) -> None:
        sharded = ShardedLattice(
            self.spec, self.schema, self._filter_expr,
            min(self.batch_capacity * self.spec.windows_per_record,
                self.spec.n_keys // self._mesh.shape["key"]
                * self.spec.n_slots),
            self._mesh, self._layout)
        self._sharded = sharded
        self._step = sharded.step
        self._extract_slot = self._count_close_kernel(sharded.extract_slot)
        self._reset_slot = self._count_close_kernel(sharded.reset_slot)
        self._extract_reset_slots = self._count_close_kernel(
            sharded.extract_reset_slots)
        self._extract_slots = sharded.extract_slots  # peek: read path
        self._reset_slots = self._count_close_kernel(sharded.reset_slots)
        self._extract_touched = sharded.extract_touched
        # the single-card state of the base __init__ gives way to the
        # partials; the key growth installs its own
        if not getattr(self, "_defer_state_init", False) \
                and not isinstance(getattr(self, "state", None),
                                   ShardedState):
            self.state = sharded.init_state()

    # contract: dispatches<=0 fetches<=0
    def device_plane_bytes(self) -> dict[str, int]:
        """Per-plane device bytes summed over the partials (nbytes
        metadata only)."""
        out: dict[str, int] = {}
        for row in self.state:
            for part in row:
                for name, v in part.items():
                    out[name] = out.get(name, 0) + int(v.nbytes)
        return out

    def _rebase_planes(self, delta: int) -> None:
        for row in self.state:
            for part in row:
                with on(part["slot_start"].device):
                    lattice.rebase(part, delta)

    def _grow_keys(self) -> None:
        """Double the global key capacity: each data shard's key shards
        gathered through the host into its [K, ...] planes, padded with
        each plane's identity, and cut into the new key ranges (keys move
        between key shards as Kl doubles)."""
        new_k = self.spec.n_keys * 2
        kinds = lattice.plane_merge_kinds(self.spec)
        old = self.state
        self.spec = lattice.LatticeSpec(
            n_keys=new_k, window=self.spec.window, aggs=self.spec.aggs,
            hll=self.spec.hll, qcfg=self.spec.qcfg,
            track_touched=self.spec.track_touched)
        self._defer_state_init = True
        try:
            self._compile()
        finally:
            self._defer_state_init = False
        nk, Kl = old.n_key, self._sharded.local_spec.n_keys
        grown = ShardedState()
        for d, row in enumerate(old):
            parts = [dict() for _ in range(nk)]
            for name in row[0]:
                if name == "slot_start":
                    for k in range(nk):
                        parts[k][name] = row[k][name]
                    continue
                # key growth re-shards through the host: one fetch per
                # plane and shard is unavoidable (the reference's rare
                # re-shard path carries the same waiver)
                # analyze: ok dispatch-sync — rare re-shard path by design
                full = torch.cat([p[name].cpu() for p in row])
                fill = (float("inf") if kinds.get(name) == "min"
                        else float("-inf") if kinds.get(name) == "max"
                        and full.dtype == torch.float32 else 0)
                pad = torch.full((new_k - full.shape[0],)
                                 + tuple(full.shape[1:]), fill,
                                 dtype=full.dtype)
                full = torch.cat([full, pad])
                for k in range(nk):
                    parts[k][name] = full[k * Kl:(k + 1) * Kl].to(
                        self._sharded.devices[d, k]).contiguous()
            grown.append(parts)
        self.state = grown

    def stage_columnar(self, key_ids, ts_ms, cols, nulls=None
                       ) -> StagedBatch | None:
        """The sharded path keeps the packed transport, so staging holds
        the batch on the host (combo None): process_staged takes it
        through the synchronous sharded step. IngestPipeline works, with
        no overlap of encode and step."""
        key_ids = np.asarray(key_ids, dtype=np.int32)
        if len(key_ids) == 0:
            return None
        ts = np.asarray(ts_ms, dtype=np.int64)
        return StagedBatch(
            n=len(key_ids), combo=None, bases=None, words=None, epoch=0,
            ts_min=int(ts.min()), ts_max=int(ts.max()),
            key_ids=key_ids, ts_ms=ts, cols=cols, nulls=nulls)

    def _process_batch(self, rows: list, ts_ms: list):
        was, self._row_cap = self._row_cap, True
        try:
            return super()._process_batch(rows, ts_ms)
        finally:
            self._row_cap = was

    def _step_cap(self, n: int) -> int:
        """The packed batch's capacity (the reference's round_up_pow2 on
        the row path, _stage_cap on the columnar one), a multiple of the
        data axis."""
        if self._row_cap:
            cap = round_up_pow2(n)
        else:
            with self._caps_lock:
                cap = next((c for c in sorted(self._caps_used)
                            if n <= c <= 8 * max(n, 1)), None)
                if cap is None:
                    cap = round_up_pow2(n, lo=min(self.batch_capacity, 4096))
                    self._caps_used.add(cap)
        D = self._sharded.n_data
        return -(-cap // D) * D

    # contract: dispatches<=1 fetches<=0
    def _run_step(self, n: int, key_ids, ts_rel, cols, nulls,
                  wm_rel: int) -> None:
        """Pack the batch (the reference's v1 packed transport, NULL masks
        numbered as its sharded path numbers them: one entry an aggregate
        with an input) and run the sharded step over every shard."""
        if FAULTS.active:  # chaos: fail/delay a step dispatch
            FAULTS.point("device.dispatch")
        valid, null_streams = self._null_valid_streams(n, nulls)
        null_masks = [null_streams.get(nk) for nk, _ in self._null_specs]
        cap = self._step_cap(n)
        packed = lattice.pack_batch_host(
            cap, n, key_ids,
            # both callers narrow ts_rel only after their own span check
            # analyze: ok overflow-narrowing — caller-guarded narrow
            np.asarray(ts_rel, dtype=np.int32), valid,
            cols, null_masks, self._layout)
        self.transfer_stats["h2d_bytes"] += int(packed.nbytes)
        self.read_epoch += 1
        with kernel_family("step", self.dispatch_observer,
                           ready=self._device_values):
            self.state = self._step(self.state, wm_rel, packed)
        self.sharded_dispatches += 1

    # contract: dispatches<=1 fetches<=1
    def _drain_changes(self) -> Any:
        """The sharded changelog: one merged extract, ONE fetch of the
        per-key-shard buffers, then the single-card batched decode (the
        key ids are already global)."""
        self.state, packed = self._extract_touched(self.state)
        self.sharded_dispatches += 1
        host = packed.cpu().numpy()          # [n_key, rows, max_out]
        self.transfer_stats["d2h_bytes"] += host.nbytes
        out = None
        for s in range(host.shape[0]):
            out = extend_rows(out, self._decode_changes(host[s], self.epoch))
        return out if out is not None else []

    def block_until_ready(self) -> None:
        for dev in {d for d in self._mesh.devices.flat}:
            if dev.type == "cuda":
                # a caller's fence over the mesh (join.py calls it; the
                # ingest path never does): one synchronize a card, as the
                # reference's block_until_ready waits on every shard
                # analyze: ok dispatch-sync — a fence over the mesh's cards
                torch.cuda.synchronize(dev)
