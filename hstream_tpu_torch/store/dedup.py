"""Producer dedup windows: exactly-once appends across retries AND
across leader failover.

A producer stamps each Append/INSERT with a monotone ``(producer_id,
seq)``. The window for a producer is a bounded map of its most recent
seqs to the ``(lsn, n_records)`` the original append landed at, plus a
high watermark, persisted in store meta under ``dedup/<producer_id>``.

The replication layer maintains the window *deterministically from the
op-log*: the producer stamp rides the replicated ``LogEntry`` itself
(proto ``producer_id``/``producer_seq``) and every replica updates the
window while applying the entry — so the window needs no separate
replication message and, crucially, a promoted follower already holds
exactly the dedup state its applied prefix implies. A retry that
straddles the promotion is answered from the new leader's window with
the ORIGINAL record ids; it cannot land twice on any replica.

Window semantics for an incoming ``seq``:

  * in the window          -> duplicate; return the recorded (lsn, n)
  * above the watermark    -> new; append, then ``record`` it
  * at/below the watermark
    but evicted            -> ``DuplicateAppend`` (ALREADY_EXISTS): the
                              retry is older than the window can vouch
                              for — refusing loudly beats silently
                              appending a possible duplicate

Single-node stores reuse the same functions straight from the Append
handler (guarded by a context-level lock); durability then follows the
store's own meta durability.
"""

# A copy of hstream_tpu/store/dedup.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import json

from hstream_tpu_torch.common.errors import DuplicateAppend

DEDUP_PREFIX = "dedup/"
# seqs remembered per producer; older retries get DuplicateAppend
DEDUP_WINDOW = 128


def _meta_key(producer_id: str) -> str:
    return DEDUP_PREFIX + producer_id


def load_window(store, producer_id: str) -> dict:
    """{"hw": int, "seqs": {str(seq): [lsn, n_records]}} (empty when
    the producer has never appended, or the blob is unreadable — a
    corrupt window only widens the ALREADY_EXISTS refusal surface,
    never duplicates). The empty watermark is -1, NOT 0: seq 0 is a
    legal first stamp (and the proto3 default when a client sets only
    producer_id), and `0 <= hw` on a never-seen producer would refuse
    its very first append as an evicted duplicate."""
    raw = store.meta_get(_meta_key(producer_id))
    if raw is None:
        return {"hw": -1, "seqs": {}}
    try:
        w = json.loads(raw)
        if not isinstance(w.get("seqs"), dict):
            raise ValueError("bad seqs")
        w["hw"] = int(w.get("hw", -1))
        return w
    except (ValueError, TypeError, AttributeError):
        return {"hw": -1, "seqs": {}}


def lookup(store, producer_id: str, seq: int):
    """None when `seq` is new (append it, then ``record``); the
    original ``(lsn, n_records)`` when it is a remembered duplicate.
    Raises DuplicateAppend for a seq at/below the watermark that the
    bounded window has already evicted."""
    w = load_window(store, producer_id)
    hit = w["seqs"].get(str(int(seq)))
    if hit is not None:
        return int(hit[0]), int(hit[1])
    if int(seq) <= w["hw"]:
        raise DuplicateAppend(
            f"producer {producer_id!r} seq {seq} is at/below the dedup "
            f"watermark {w['hw']} but outside the {DEDUP_WINDOW}-entry "
            f"window; the append may already be stored")
    return None


def record(store, producer_id: str, seq: int, lsn: int,
           n_records: int) -> None:
    """Remember (seq -> lsn, n) for the producer, evicting the oldest
    seqs past DEDUP_WINDOW. Idempotent — replay after a crash in the
    apply/log window rewrites the same entry."""
    w = load_window(store, producer_id)
    w["seqs"][str(int(seq))] = [int(lsn), int(n_records)]
    w["hw"] = max(w["hw"], int(seq))
    if len(w["seqs"]) > DEDUP_WINDOW:
        for old in sorted(w["seqs"], key=int)[:len(w["seqs"])
                                              - DEDUP_WINDOW]:
            del w["seqs"][old]
    store.meta_put(_meta_key(producer_id),
                   json.dumps(w, sort_keys=True).encode())


def window_size(store) -> int:
    """Total remembered seqs across producers (the dedup_window_size
    gauge; scrape cost is bounded by the number of producers)."""
    total = 0
    for key in store.meta_list(DEDUP_PREFIX):
        raw = store.meta_get(key)
        if raw is None:
            continue
        try:
            total += len(json.loads(raw).get("seqs", {}))
        except (ValueError, TypeError, AttributeError):
            continue
    return total


def guarded_append(store, lock, logid: int, payloads, compression,
                   producer_id: str, producer_seq: int, *,
                   append_time_ms=None):
    """Dedup-checked append for a NON-replicated store: lookup and
    append+record are atomic under `lock` (the replicated store does
    the same inside its own critical section so the window update
    rides the op-log entry). Returns (lsn, n_records, was_duplicate).
    """
    with lock:
        hit = lookup(store, producer_id, producer_seq)
        if hit is not None:
            return hit[0], hit[1], True
        lsn = store.append_batch(logid, payloads, compression,
                                 append_time_ms=append_time_ms)
        record(store, producer_id, producer_seq, lsn, len(payloads))
        return lsn, len(payloads), False
