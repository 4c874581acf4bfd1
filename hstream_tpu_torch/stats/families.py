"""Declarative stat families: the ``.inc`` X-macro analogue, enforced.

Reference: adding a per-stream metric is ONE line in
``per_stream_time_series.inc`` — the registry, the holder wiring, and
the admin aggregation all derive from it at compile time
(common/include/per_stream_time_series.inc:24-40). Python cannot get
that from the compiler, so this table is the single declaration point
and two mechanisms restore the property:

  * ``StatsHolder.stat_add`` auto-creates a MultiLevelTimeSeries from
    the row here (unknown family -> KeyError, even on a cold path);
  * the analyzer's registry pass (rule ``registry-family``) machine-
    checks that every literal ``stat_add``/``stat_rate``/... call site
    in the production tree names a declared family, and that every
    declared family has at least one call site (``registry-dead``).

One row declares: the family name, its scope (the entity kind the key
labels — ``stream`` / ``subscription`` / ``query``), the unit the
values carry, and the HELP text the exposition serves. Every family
gets the full default ladder (60x1s / 60x10s / 60x60s + all-time);
rates surface per entity via ``admin stats <scope>s --interval ...``,
``GET /stats``, the ``stream_rate`` exposition ladder, and the
``NodeStatsReport`` federation fold (stats/cluster.py).
"""

# A copy of hstream_tpu/stats/families.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

from typing import NamedTuple


class StatFamily(NamedTuple):
    name: str
    scope: str  # "stream" | "subscription" | "query"
    unit: str
    help: str


# ---- the table (one line per family; keep scopes grouped) ------------------

STAT_FAMILIES = [
    # per-stream ingest/egress (the reference's appends/reads ladders)
    StatFamily("append_in_bytes", "stream", "bytes",
               "append byte rate over the trailing window"),
    StatFamily("append_in_records", "stream", "records",
               "append record rate over the trailing window"),
    StatFamily("record_bytes", "stream", "bytes",
               "read byte rate over the trailing window"),
    StatFamily("read_out_records", "stream", "records",
               "read record rate over the trailing window"),
    # per-subscription delivery (reference subscription_time_series)
    StatFamily("delivered_records", "subscription", "records",
               "records delivered to consumers over the trailing "
               "window"),
    StatFamily("delivered_bytes", "subscription", "bytes",
               "payload bytes delivered to consumers over the "
               "trailing window"),
    StatFamily("acks_received", "subscription", "records",
               "record acknowledgements received over the trailing "
               "window"),
    # per-query emission (the close-cycle heartbeat of a continuous
    # query: rows on the wire and cycles completed)
    StatFamily("emit_rows", "query", "rows",
               "aggregate rows emitted over the trailing window"),
    StatFamily("close_cycles", "query", "cycles",
               "window close cycles emitted over the trailing window"),
    # multi-chip execution: device dispatches that ran
    # under shard_map — the rate a sharded query's fused kernels hit
    # the mesh (zero for single-chip queries)
    StatFamily("sharded_dispatches", "query", "dispatches",
               "device dispatches executed under shard_map over the "
               "trailing window"),
]

FAMILY_NAMES = frozenset(f.name for f in STAT_FAMILIES)
FAMILY_BY_NAME = {f.name: f for f in STAT_FAMILIES}
FAMILY_SCOPES = ("stream", "subscription", "query")


def families_for_scope(scope: str) -> list[StatFamily]:
    if scope not in FAMILY_SCOPES:
        raise KeyError(f"unknown stat scope {scope!r} "
                       f"(one of {FAMILY_SCOPES})")
    return [f for f in STAT_FAMILIES if f.scope == scope]
