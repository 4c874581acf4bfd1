"""Node scoring: fold one published node record into a load score.

The record is the bounded ``node_record_fields`` shape every armed
placer publishes to ``cluster/nodes/<node>`` each tick (the same axes
``NodeStatsReport`` and the ``node_load_report`` journal event carry:
rss, device HBM bytes, append-front depth, running queries, dispatch
p99, health counts).
Lower score = preferred. The fold is deliberately simple and DOCUMENTED
(README "Placement & failover adoption"); determinism matters more than
cleverness — two placers ranking the same records must pick the same
winner, so ties break on the node name.
"""

# A copy of hstream_tpu/placer/score.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import time

# score weights: one running query costs as much as 5 staged-but-
# unstepped batches; a DEGRADED query as much as a running one; a
# STALLED query dominates everything but ineligibility
W_RUNNING_QUERIES = 10.0
W_APPEND_INFLIGHT = 2.0
W_APPEND_FRONT = 2.0
W_ARENA_PENDING = 2.0
W_DISPATCH_P99_MS = 1.0
W_RSS_GB = 1.0
# device HBM is the scarce axis on an accelerator host: a GB of live
# arena bytes costs 5x a GB of host rss (the record carries
# device_hbm_bytes from the HBM accounting plane; nodes without device
# executors report 0 and the term vanishes)
W_HBM_GB = 5.0
W_DEGRADED = 10.0
W_STALLED = 100.0

# machine-readable ineligibility reasons (admin `placer` surfaces them)
SKIP_STALE = "stale-record"      # node record heartbeat lapsed
SKIP_FENCED = "fenced"           # store fenced by a higher epoch
SKIP_SHEDDING = "shedding"       # overload ladder at DEFER or worse
SKIP_STALLED = "stalled-queries"  # node reports STALLED queries


def node_score(record: dict) -> float:
    """Load score of one node record; lower = preferred."""
    health = record.get("health") or {}
    return round(
        W_RUNNING_QUERIES * float(record.get("running_queries", 0))
        + W_APPEND_INFLIGHT * float(record.get("append_inflight", 0))
        + W_APPEND_FRONT * float(
            (record.get("append_front") or {}).get("in_flight", 0))
        + W_ARENA_PENDING * float(
            record.get("arena_pending_batches", 0))
        + W_DISPATCH_P99_MS * float(record.get("dispatch_p99_ms") or 0.0)
        + W_RSS_GB * float(record.get("rss_bytes", 0)) / 1e9
        + W_HBM_GB * float(record.get("device_hbm_bytes", 0)) / 1e9
        + W_DEGRADED * float(health.get("degraded", 0))
        + W_STALLED * float(health.get("stalled", 0)), 3)


def skip_reason(record: dict, *, lease_ms: int,
                now_ms: int | None = None) -> str | None:
    """Why this node must not receive placements (None = eligible).
    Skip STALLED / breaker-open / fenced nodes — a node
    reporting stalled queries is either overloaded or sick, and a
    fenced store cannot own anything."""
    if now_ms is None:
        now_ms = int(time.time() * 1000)
    hb = record.get("hb_ms") or record.get("ts_ms") or 0
    if now_ms - int(hb) > int(lease_ms):
        return SKIP_STALE
    if record.get("fenced"):
        return SKIP_FENCED
    if int(record.get("shed_level", 0)) >= 1:
        return SKIP_SHEDDING
    if int((record.get("health") or {}).get("stalled", 0)) > 0:
        return SKIP_STALLED
    return None


def rank_nodes(records: dict[str, dict], *, lease_ms: int,
               now_ms: int | None = None
               ) -> tuple[list[tuple[float, str]], dict[str, str]]:
    """(ranked eligible [(score, node)] best-first, skipped
    {node: reason}). Deterministic: score then node name."""
    ranked: list[tuple[float, str]] = []
    skipped: dict[str, str] = {}
    for node, rec in records.items():
        reason = skip_reason(rec, lease_ms=lease_ms, now_ms=now_ms)
        if reason is not None:
            skipped[node] = reason
            continue
        ranked.append((node_score(rec), node))
    ranked.sort()
    return ranked, skipped
